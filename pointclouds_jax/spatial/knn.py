"""Batched KNN and radius queries: brute-force and grid-hash backends.

Replaces the reference's per-point KD-tree queries
(ref: crates/spatial/src/kdtree.rs:64-163) with whole-cloud batched kernels.
The brute-force path is the always-exact differential reference (tiled so the
[Q, N] distance matrix never fully materializes); the grid path is the fast
one, returning exactness flags the host engine uses for retry.

Distances returned are Euclidean (not squared), ascending — matching the
reference KNN contract. Edge cases mirror the KD-tree: empty cloud / k == 0 /
non-finite query -> no results; k > n -> all points.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .grid import GridHash, build_grid, gather_candidates

# Query-chunk length for lax.map tiling; bounds peak memory at
# CHUNK x N (brute force) or CHUNK x 27M (grid).
CHUNK = 1024


def _pad_queries(q, fill=0.0):
    qn = q.shape[0]
    pad = (-qn) % CHUNK
    if pad:
        q = jnp.concatenate([q, jnp.full((pad,) + q.shape[1:], fill, q.dtype)], axis=0)
    return q, qn


def _query_finite(qxyz):
    return jnp.all(jnp.isfinite(qxyz), axis=-1)


# ── Brute force ──────────────────────────────────────────────────────────────


@partial(jax.jit, static_argnames=("k",))
def bruteforce_knn(pxyz, pvalid, qxyz, qvalid, k: int):
    """Exact KNN of each query against all valid points.

    Returns (dists f32[Q, k], idx i32[Q, k], nvalid bool[Q, k]).
    ``nvalid`` marks real results (fewer than k when fewer than k points
    exist or the query is invalid/non-finite).
    """
    pfinite = jnp.all(jnp.isfinite(pxyz), axis=-1)
    puse = jnp.logical_and(pvalid, pfinite)

    # The |q|^2+|p|^2-2qp matmul form has f32 cancellation error ~eps*|q|^2
    # (absolute, not relative): at UTM-scale offsets (1e5) it exceeds real
    # neighbor distances entirely, so even a "preselect wide then re-rank"
    # scheme fails — the true neighbor never makes the preselected set.
    # Euclidean distances are translation-invariant, so center both sides on
    # the cloud's AABB midpoint first; the error then scales with the cloud
    # SPAN, not its offset. The exact difference-based recompute below
    # removes the residual error on the preselected set (parity: kiddo
    # computes exact f32 SquaredEuclidean).
    plo = jnp.min(jnp.where(puse[:, None], pxyz, jnp.inf), axis=0)
    phi = jnp.max(jnp.where(puse[:, None], pxyz, -jnp.inf), axis=0)
    center = jnp.where(jnp.isfinite(plo), 0.5 * plo + 0.5 * phi, 0.0)
    pc_xyz = jnp.where(puse[:, None], pxyz - center, 0.0)
    p2 = jnp.sum(pc_xyz * pc_xyz, axis=-1)

    n = pxyz.shape[0]
    k_eff = min(k, n)
    k_sel = min(max(2 * k_eff, k_eff + 8), n)

    q_use = jnp.logical_and(qvalid, _query_finite(qxyz))
    qpad, qn = _pad_queries(qxyz)
    upad, _ = _pad_queries(q_use, fill=False)

    def chunk_fn(args):
        qc, uc = args
        qcc = jnp.where(uc[:, None], qc - center, 0.0)
        # |q-p|^2 = |q|^2 + |p|^2 - 2 q.p ; the q.p term is a matmul.
        # HIGHEST precision: a reduced-precision f32 matmul (bf16 or TF32)
        # carries a ~0.1-0.4% relative error on |q.p| (~0.3 absolute at
        # 10-m coordinates) that silently drops true neighbors from the
        # preselection, which the exact recompute can then never recover.
        qp = jax.lax.dot(qcc, pc_xyz.T, precision=jax.lax.Precision.HIGHEST)
        d2 = jnp.sum(qcc * qcc, axis=-1)[:, None] + p2[None, :] - 2.0 * qp
        d2 = jnp.where(jnp.logical_and(uc[:, None], puse[None, :]), d2, jnp.inf)
        neg, pre_idx = jax.lax.top_k(-d2, k_sel)
        # Exact recompute of the preselected candidates on RAW coordinates:
        # nearby-f32 subtraction is exact (Sterbenz), matching kiddo.
        cand = jnp.take(pxyz, pre_idx, axis=0)  # [C, k_sel, 3]
        diff = cand - qc[:, None, :]
        d2x = jnp.sum(diff * diff, axis=-1)
        d2x = jnp.where(jnp.isfinite(-neg), d2x, jnp.inf)
        neg2, pos = jax.lax.top_k(-d2x, k_eff)
        idx = jnp.take_along_axis(pre_idx, pos, axis=1)
        if k_eff < k:  # capacity smaller than k: pad result columns
            neg2 = jnp.pad(
                neg2, ((0, 0), (0, k - k_eff)), constant_values=-jnp.inf
            )
            idx = jnp.pad(idx, ((0, 0), (0, k - k_eff)))
        return -neg2, idx

    nchunks = qpad.shape[0] // CHUNK
    d2s, idxs = jax.lax.map(
        chunk_fn,
        (qpad.reshape(nchunks, CHUNK, 3), upad.reshape(nchunks, CHUNK)),
    )
    d2s = d2s.reshape(-1, k)[:qn]
    idxs = idxs.reshape(-1, k)[:qn].astype(jnp.int32)
    nvalid = jnp.isfinite(d2s)
    dists = jnp.sqrt(jnp.maximum(d2s, 0.0))
    dists = jnp.where(nvalid, dists, jnp.inf)
    return dists, idxs, nvalid


@jax.jit
def bruteforce_radius_count(pxyz, pvalid, qxyz, qvalid, radius):
    """Number of valid points with distance <= radius of each query
    (inclusive boundary, like the reference's epsilon-padded search +
    post-filter, ref: crates/spatial/src/kdtree.rs:105-135)."""
    pfinite = jnp.all(jnp.isfinite(pxyz), axis=-1)
    puse = jnp.logical_and(pvalid, pfinite)
    q_use = jnp.logical_and(qvalid, _query_finite(qxyz))
    r2 = radius * radius

    qpad, qn = _pad_queries(qxyz)
    upad, _ = _pad_queries(q_use, fill=False)

    def chunk_fn(args):
        qc, uc = args
        diff = qc[:, None, :] - pxyz[None, :, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        ok = jnp.logical_and(
            jnp.logical_and(uc[:, None], puse[None, :]), d2 <= r2
        )
        return jnp.sum(ok.astype(jnp.int32), axis=1)

    nchunks = qpad.shape[0] // CHUNK
    counts = jax.lax.map(
        chunk_fn,
        (qpad.reshape(nchunks, CHUNK, 3), upad.reshape(nchunks, CHUNK)),
    )
    return counts.reshape(-1)[:qn]


@jax.jit
def radius_within_mask(pxyz, pvalid, query, radius):
    """bool[N] mask of valid points with distance <= radius of one query.

    Single-query radius search as one streaming pass of direct
    (translation-safe) f32 differences over the whole cloud instead of a
    tree walk: the read is contiguous and the compare elementwise. Inclusive boundary in f32 squared distance, like
    the reference's epsilon-padded search + `<=` post-filter
    (ref: crates/spatial/src/kdtree.rs:105-163).
    """
    pfinite = jnp.all(jnp.isfinite(pxyz), axis=-1)
    puse = jnp.logical_and(pvalid, pfinite)
    diff = pxyz - query[None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    return jnp.logical_and(puse, d2 <= radius * radius)


# ── Grid backend ─────────────────────────────────────────────────────────────


@partial(jax.jit, static_argnames=("k", "m_per_cell"))
def grid_knn(grid: GridHash, qxyz, qvalid, k: int, m_per_cell: int):
    """KNN over the 27-cell neighborhood of each query.

    Returns (dists, idx, nvalid, overflow, insufficient). Results are
    certified exact iff neither flag is set:
    - ``overflow``: some candidate cell held more than M points (results may
      be incomplete) — the host engine retries with a larger cap.
    - ``insufficient``: some query's kth-neighbor distance is not safely
      inside one cell width (so closer points might exist beyond the 27
      cells), or fewer than min(k, num_valid) candidates were found — the
      engine retries with a larger cell.

    The one-cell-width bound carries an f32 safety margin: cell assignment
    floors p/cell, whose rounding error grows with |p|/cell, so a point at
    distance ~cell can land 2 cells away when coordinates are many cells
    from the origin.
    """
    q_use = jnp.logical_and(qvalid, _query_finite(qxyz))
    qpad, qn = _pad_queries(qxyz)
    upad, _ = _pad_queries(q_use, fill=False)
    nchunks = qpad.shape[0] // CHUNK

    # Safe radius: distances below this are guaranteed to lie within the
    # 27-cell neighborhood despite f32 floor(p/cell) rounding.
    max_quot = jnp.max(
        jnp.where(
            jnp.logical_and(q_use, _query_finite(qxyz))[:, None],
            jnp.abs(qxyz / grid.cell_size),
            0.0,
        )
    )
    margin = (max_quot * 4.0 * 1.2e-7 + 1e-6) * grid.cell_size
    safe_cell = jnp.maximum(grid.cell_size - margin, 0.0)
    safe_cell2 = safe_cell * safe_cell

    def chunk_fn(args):
        qc, uc = args
        cand_idx, d2, cand_valid, overflow = gather_candidates(
            grid, qc, uc, m_per_cell
        )
        k_eff = min(k, d2.shape[-1])
        neg, pos = jax.lax.top_k(-d2, k_eff)
        if k_eff < k:  # fewer candidate slots than k: flags force a retry
            neg = jnp.pad(neg, ((0, 0), (0, k - k_eff)), constant_values=-jnp.inf)
            pos = jnp.pad(pos, ((0, 0), (0, k - k_eff)))
        d2k = -neg
        idx = jnp.take_along_axis(cand_idx, pos, axis=1)
        nvalid = jnp.isfinite(d2k)
        found = jnp.sum(cand_valid.astype(jnp.int32), axis=1)
        kth_d2 = d2k[:, k - 1]
        have_k = found >= k
        want = jnp.minimum(k, grid.num_valid)
        bad = jnp.where(have_k, kth_d2 > safe_cell2, found < want)
        insufficient = jnp.any(jnp.logical_and(uc, bad))
        return d2k, idx, nvalid, overflow, insufficient

    d2s, idxs, nvalids, overflows, insuffs = jax.lax.map(
        chunk_fn,
        (qpad.reshape(nchunks, CHUNK, 3), upad.reshape(nchunks, CHUNK)),
    )
    d2s = d2s.reshape(-1, k)[:qn]
    idxs = idxs.reshape(-1, k)[:qn].astype(jnp.int32)
    nvalid = nvalids.reshape(-1, k)[:qn]
    dists = jnp.where(nvalid, jnp.sqrt(jnp.maximum(d2s, 0.0)), jnp.inf)
    return dists, idxs, nvalid, jnp.any(overflows), jnp.any(insuffs)


@partial(jax.jit, static_argnames=("m_per_cell",))
def grid_radius_count(grid: GridHash, qxyz, qvalid, radius, m_per_cell: int):
    """Count of points with distance <= radius. Exact iff radius <=
    grid.cell_size and no cell overflowed the cap (returned as flag)."""
    q_use = jnp.logical_and(qvalid, _query_finite(qxyz))
    qpad, qn = _pad_queries(qxyz)
    upad, _ = _pad_queries(q_use, fill=False)
    nchunks = qpad.shape[0] // CHUNK
    r2 = radius * radius

    def chunk_fn(args):
        qc, uc = args
        _, d2, _, overflow = gather_candidates(grid, qc, uc, m_per_cell)
        counts = jnp.sum((d2 <= r2).astype(jnp.int32), axis=1)
        return counts, overflow

    counts, overflows = jax.lax.map(
        chunk_fn,
        (qpad.reshape(nchunks, CHUNK, 3), upad.reshape(nchunks, CHUNK)),
    )
    return counts.reshape(-1)[:qn], jnp.any(overflows)


@partial(jax.jit, static_argnames=("m_per_cell",))
def grid_radius_neighbors(grid: GridHash, qxyz, qvalid, radius, m_per_cell: int):
    """Capped neighbor lists within radius (inclusive), for clustering.

    Returns (idx i32[Q, 27*M], within bool[Q, 27*M], overflow). ``idx`` holds
    original point indices; ``within`` marks entries at distance <= radius.
    Exact iff radius <= cell_size and not overflow.
    """
    q_use = jnp.logical_and(qvalid, _query_finite(qxyz))
    qpad, qn = _pad_queries(qxyz)
    upad, _ = _pad_queries(q_use, fill=False)
    nchunks = qpad.shape[0] // CHUNK
    r2 = radius * radius

    def chunk_fn(args):
        qc, uc = args
        cand_idx, d2, _, overflow = gather_candidates(grid, qc, uc, m_per_cell)
        return cand_idx, d2 <= r2, overflow

    idxs, withins, overflows = jax.lax.map(
        chunk_fn,
        (qpad.reshape(nchunks, CHUNK, 3), upad.reshape(nchunks, CHUNK)),
    )
    m = idxs.shape[-1]
    return (
        idxs.reshape(-1, m)[:qn].astype(jnp.int32),
        withins.reshape(-1, m)[:qn],
        jnp.any(overflows),
    )
