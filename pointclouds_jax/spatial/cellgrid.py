"""Cell-centric dense grid: the fast neighbor engine.

A searchsorted-per-query design pays a binary search (17 sequential gather
steps) and a small per-query row gather for every query. This module
replaces both:

- cell lookup becomes ONE scatter into a dense linear-id -> slot table at
  build time and direct O(1) gathers at query time (no binary search);
- candidate access becomes per-cell *block* gathers: points are scattered
  into dense ``[C, M, 3]`` per-cell blocks once, and each occupied cell
  fetches its 27 neighbor blocks as contiguous slices — queries are the
  cell's own points, so the gather cost is amortized over all points in the
  cell and its granularity is M*3 floats per slice instead of 3.

Linear cell ids are int32 computed relative to the cloud's min cell (so no
int64 sort on the hot path); clouds whose cell-extent product exceeds the
table capacity set ``table_overflow`` and callers fall back to the exact
int64 searchsorted engine (spatial/grid.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

def ring_offsets(ring: int) -> np.ndarray:
    r = range(-ring, ring + 1)
    return np.array(
        [(dx, dy, dz) for dx in r for dy in r for dz in r], dtype=np.int32
    )


NEIGHBOR_OFFSETS = ring_offsets(1)

DEFAULT_TABLE_SIZE = 1 << 21  # 2M cells, 8 MB int32


class CellGrid(NamedTuple):
    cell_xyz: jax.Array  # f32[C, M, 3] dense per-cell point blocks
    cell_xyzw: jax.Array  # f32[C, M, 4] xyz + original row id in w (-1 for
    # padding): one gather fetches coordinates, validity (w >= 0), AND the
    # index instead of three separate small-slice gathers. Exact for clouds
    # under 2^24 points.
    cell_idx: jax.Array  # i32[C, M] original row ids
    cell_mask: jax.Array  # bool[C, M]
    neighbor_slots: jax.Array  # i32[C, 27] slot of each neighbor cell (C if absent)
    point_slot: jax.Array  # i32[N] cell slot of each original point (C if invalid)
    num_cells: jax.Array  # i32
    table: jax.Array  # i32[T+1] linear id -> slot (cell_cap if absent)
    min_coord: jax.Array  # i32[3] cell-coordinate origin
    extent: jax.Array  # i32[3]
    cell_size: jax.Array  # f32
    overflow: jax.Array  # bool: some cell holds > M points
    table_overflow: jax.Array  # bool: extent exceeded the table capacity


@partial(
    jax.jit, static_argnames=("m_per_cell", "cell_cap", "table_size", "ring")
)
def build_cellgrid(
    xyz,
    valid,
    cell_size,
    *,
    m_per_cell: int,
    cell_cap: int,
    table_size: int = DEFAULT_TABLE_SIZE,
    ring: int = 1,
) -> CellGrid:
    n = xyz.shape[0]
    if n >= 1 << 24:
        # Row ids ride the f32 w channel of cell_xyzw (exact integers only
        # up to 2^24); beyond that neighbor indices and cluster labels would
        # silently corrupt. Callers (spatial/engine.py) route such clouds to
        # the int64 searchsorted engine or brute force instead.
        raise ValueError(
            f"cell grid supports at most 2^24 points (got {n}); "
            "use the int64 grid engine for larger clouds"
        )
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    use = jnp.logical_and(valid, finite)

    c = jnp.floor(xyz / cell_size)
    c = jnp.clip(c, -1e9, 1e9).astype(jnp.int32)
    big = jnp.int32(2**30)
    mn = jnp.min(jnp.where(use[:, None], c, big), axis=0)
    mn = jnp.minimum(mn, big - 1)  # all-invalid guard
    rel = jnp.clip(c - mn[None, :], 0, None)
    mx = jnp.max(jnp.where(use[:, None], rel, 0), axis=0)
    extent = mx + 1  # i32[3]

    # Linear id in i64 first to detect table overflow, then clamp to i32.
    ext64 = extent.astype(jnp.int64)
    lin64 = (
        rel[:, 0].astype(jnp.int64) * ext64[1] + rel[:, 1].astype(jnp.int64)
    ) * ext64[2] + rel[:, 2].astype(jnp.int64)
    table_overflow = (ext64[0] * ext64[1] * ext64[2]) > table_size
    lin = jnp.where(use, jnp.clip(lin64, 0, table_size - 1), table_size).astype(
        jnp.int32
    )

    order = jnp.argsort(lin, stable=True)
    slin = lin[order]
    sxyz = xyz[order]
    sidx = order.astype(jnp.int32)
    suse = slin < table_size

    first = jnp.concatenate([jnp.ones((1,), bool), slin[1:] != slin[:-1]])
    first = jnp.logical_and(first, suse)
    slot = jnp.cumsum(first.astype(jnp.int32)) - 1  # [N], grows over segments
    slot = jnp.where(suse, slot, cell_cap)
    num_cells = jnp.sum(first.astype(jnp.int32))

    pos = jnp.arange(n, dtype=jnp.int32)
    seg_start = jax.lax.cummax(jnp.where(first, pos, -1))
    rank = pos - seg_start

    in_block = jnp.logical_and(suse, rank < m_per_cell)
    overflow = jnp.any(jnp.logical_and(suse, rank >= m_per_cell))
    overflow = jnp.logical_or(overflow, num_cells > cell_cap)

    sslot = jnp.where(in_block, slot, cell_cap)
    srank = jnp.where(in_block, rank, 0)

    cell_xyz = (
        jnp.zeros((cell_cap + 1, m_per_cell, 3), jnp.float32)
        .at[sslot, srank]
        .set(sxyz, mode="drop")[:cell_cap]
    )
    sxyzw = jnp.concatenate(
        [sxyz, jnp.where(in_block, sidx.astype(jnp.float32), -1.0)[:, None]],
        axis=1,
    )
    cell_xyzw = (
        jnp.zeros((cell_cap + 1, m_per_cell, 4), jnp.float32)
        .at[:, :, 3]
        .set(-1.0)
        .at[sslot, srank]
        .set(sxyzw, mode="drop")[:cell_cap]
    )
    cell_idx = (
        jnp.full((cell_cap + 1, m_per_cell), n, jnp.int32)
        .at[sslot, srank]
        .set(sidx, mode="drop")[:cell_cap]
    )
    cell_mask = (
        jnp.zeros((cell_cap + 1, m_per_cell), bool)
        .at[sslot, srank]
        .set(in_block, mode="drop")[:cell_cap]
    )

    # Dense linear-id -> slot table (one scatter; first rows only).
    tbl_idx = jnp.where(first, slin, table_size)
    table = (
        jnp.full((table_size + 1,), cell_cap, jnp.int32)
        .at[tbl_idx]
        .set(jnp.where(first, slot, cell_cap), mode="drop")
    )

    # Per-slot rel coords (scatter from first rows), then neighbor lookups.
    srel = rel[order]
    cell_rel = (
        jnp.zeros((cell_cap + 1, 3), jnp.int32)
        .at[jnp.where(first, slot, cell_cap)]
        .set(srel, mode="drop")[:cell_cap]
    )
    noff = jnp.asarray(ring_offsets(ring))  # [K, 3] (27 for ring 1, 125 for 2)
    nrel = cell_rel[:, None, :] + noff[None, :, :]  # [C, K, 3]
    in_bounds = jnp.all(
        jnp.logical_and(nrel >= 0, nrel < extent[None, None, :]), axis=-1
    )
    nlin = (
        nrel[..., 0] * extent[1] + nrel[..., 1]
    ) * extent[2] + nrel[..., 2]
    nlin = jnp.where(in_bounds, nlin, table_size)
    neighbor_slots = jnp.take(
        table, nlin.reshape(-1), axis=0
    ).reshape(nlin.shape)  # [C, K]
    # Slots >= num_cells are stale block rows; mask them out.
    slot_valid = (
        jnp.arange(cell_cap, dtype=jnp.int32)[:, None] < num_cells
    )
    neighbor_slots = jnp.where(
        jnp.logical_and(neighbor_slots < num_cells, slot_valid),
        neighbor_slots,
        cell_cap,
    )

    # Map back: original point row -> its cell slot.
    point_slot = (
        jnp.full((n + 1,), cell_cap, jnp.int32)
        .at[jnp.where(suse, sidx, n)]
        .set(sslot, mode="drop")[:n]
    )

    return CellGrid(
        cell_xyz=cell_xyz,
        cell_xyzw=cell_xyzw,
        cell_idx=cell_idx,
        cell_mask=cell_mask,
        neighbor_slots=neighbor_slots,
        point_slot=point_slot,
        num_cells=num_cells,
        table=table,
        min_coord=mn,
        extent=extent,
        cell_size=jnp.asarray(cell_size, jnp.float32),
        overflow=overflow,
        table_overflow=table_overflow,
    )


CELL_CHUNK = 2048


def cert_cell2(grid: CellGrid):
    """Squared certification radius: one cell width minus an f32 margin.

    Cell assignment floors p/cell, whose rounding error grows with
    |coordinate|/cell: far from the origin a true neighbor at distance just
    under cell_size can land TWO cells away and be missed while the naive
    ``kth_d2 <= cell_size^2`` certificate still passes. Shrink the certified
    radius by that worst-case displacement (same margin grid.py's grid_knn
    derives), bounding |coordinate|/cell from the grid's own cell extents.
    """
    hi = jnp.max(
        jnp.maximum(
            jnp.abs(grid.min_coord), jnp.abs(grid.min_coord + grid.extent)
        ).astype(jnp.float32)
    )
    margin = (hi * 4.0 * 1.2e-7 + 1e-6) * grid.cell_size
    safe = jnp.maximum(grid.cell_size - margin, 0.0)
    return safe * safe


def gather_neighbor_blocks(grid: CellGrid, slots_chunk):
    """[c, 27, M, ...] neighbor blocks for a chunk of cell slots (the one
    big, block-granular gather).

    Sources are viewed as flat [C, M*3] rows and indices flattened before
    the take, so each index fetches one contiguous block.
    """
    cap, m, _ = grid.cell_xyz.shape
    flat = jnp.minimum(slots_chunk, cap - 1).reshape(-1)
    absent = slots_chunk >= cap
    nb_xyz = (
        jnp.take(grid.cell_xyz.reshape(cap, m * 3), flat, axis=0)
        .reshape(slots_chunk.shape + (m, 3))
    )
    nb_mask = jnp.logical_and(
        jnp.take(grid.cell_mask, flat, axis=0).reshape(
            slots_chunk.shape + (m,)
        ),
        jnp.logical_not(absent)[..., None],
    )
    nb_idx = jnp.take(grid.cell_idx, flat, axis=0).reshape(
        slots_chunk.shape + (m,)
    )
    return nb_xyz, nb_mask, nb_idx


def gather_neighbor_xyzw(grid: CellGrid, slots_chunk):
    """One-gather neighbor blocks: [..., M, 4] xyzw with validity in w
    (zeroed for absent neighbor slots)."""
    cap, m, _ = grid.cell_xyzw.shape
    flat = jnp.minimum(slots_chunk, cap - 1).reshape(-1)
    absent = slots_chunk >= cap
    nb = jnp.take(grid.cell_xyzw.reshape(cap, m * 4), flat, axis=0).reshape(
        slots_chunk.shape + (m, 4)
    )
    w = jnp.where(absent[..., None], -1.0, nb[..., 3])
    return nb[..., :3], w >= 0.0


def _chunk_cells(grid: CellGrid, chunk: int):
    """Number of [chunk]-cell tiles for lax.map tiling (cell_cap must be a
    multiple of the chunk size)."""
    cap = grid.cell_xyz.shape[0]
    assert cap % chunk == 0, f"cell_cap {cap} % {chunk} != 0"
    return cap // chunk


def _smallest_k_sum_count(d2, valid, k: int, cap_d2):
    """Sum and count of the k smallest valid sqrt-distances per row, plus the
    kth smallest value, via iterative min-extraction (cheaper than a full
    top_k at small k over small candidate sets). d2: [..., C]."""
    big = jnp.inf
    work = jnp.where(valid, d2, big)
    total = jnp.zeros(d2.shape[:-1], jnp.float32)
    count = jnp.zeros(d2.shape[:-1], jnp.int32)
    kth = jnp.zeros(d2.shape[:-1], jnp.float32)

    def body(_, state):
        # One argmin pass + an element gather for the value (a separate
        # jnp.min would stream the work array a second time per iteration).
        work, total, count, kth = state
        am = jnp.argmin(work, axis=-1)
        m = jnp.take_along_axis(work, am[..., None], axis=-1)[..., 0]
        ok = jnp.isfinite(m)
        hit = jnp.where(ok, jnp.sqrt(jnp.maximum(m, 0.0)), 0.0)
        total = total + hit
        count = count + ok.astype(jnp.int32)
        kth = jnp.where(ok, m, kth)
        hit_mask = (
            jnp.arange(work.shape[-1], dtype=jnp.int32) == am[..., None]
        )
        work = jnp.where(hit_mask, big, work)
        return work, total, count, kth

    _, total, count, kth = jax.lax.fori_loop(
        0, k, body, (work, total, count, kth)
    )
    del cap_d2
    return total, count, kth


def _segmented_smallest_k(d2, valid, k: int, segments: int = 128, per_seg: int = 4):
    """Sum/count/kth of the k smallest valid sqrt-distances per row, via
    segmented extraction with a per-row exactness certificate.

    The plain k-pass min-extraction streams the full [..., W] work array k
    times (k=21 at SOR defaults). Here the candidate axis is split into ``segments`` interleaved
    segments; ``per_seg`` minima are extracted from each (per_seg sweeps),
    and the k smallest of the segments*per_seg finalists are taken by the
    small-width extraction. The result is EXACT iff no segment contributed
    more than per_seg of the true top-k — certified per row by checking
    kth_overall <= every segment's per_seg-th extracted value (a segment
    whose per_seg-th minimum is larger can hide nothing smaller than kth).
    Interleaved segmentation (candidate j -> segment j % segments)
    decorrelates segments from the spatially-coherent block order, so the
    certificate holds for ~98% of queries at SOR shapes; the rest are
    flagged (ok=False) and resolved by the callers' existing rescue pass.

    Returns (total, count, kth, ok). ``count`` is the number of finite
    valid candidates over the FULL width (one cheap extra sweep), matching
    `_smallest_k_sum_count`'s count semantics.
    """
    w = d2.shape[-1]
    lead = d2.shape[:-1]
    pad = (-w) % segments
    big = jnp.inf
    work = jnp.where(valid, d2, big)
    count_all = jnp.sum(jnp.isfinite(work).astype(jnp.int32), axis=-1)
    if pad:
        work = jnp.concatenate(
            [work, jnp.full(lead + (pad,), big, d2.dtype)], axis=-1
        )
    # [..., W/S, S]: segment = column index = candidate j % segments.
    # Interleaving matters twice over: (a) candidate order is spatially
    # coherent (blocks), so CONTIGUOUS segments would concentrate the true
    # top-k into one or two segments and fail the certificate for most
    # rows; (b) segments on the MINOR axis with S=128 keep every sweep
    # perfectly tiled (a 16-wide minor axis padded 8x and erased the win).
    ws = work.reshape(lead + ((w + pad) // segments, segments))

    def seg_body(_, state):
        ws, vals, j = state
        m = jnp.min(ws, axis=-2)  # [..., S]
        am = jnp.argmin(ws, axis=-2)
        hit = (
            jnp.arange(ws.shape[-2], dtype=jnp.int32)[:, None]
            == am[..., None, :]
        )
        ws = jnp.where(hit, big, ws)
        vals = jax.lax.dynamic_update_index_in_dim(vals, m, j, axis=-2)
        return ws, vals, j + 1

    vals0 = jnp.full(lead + (per_seg, segments), jnp.float32(big))
    _, vals, _ = jax.lax.fori_loop(
        0, per_seg, seg_body, (ws, vals0, 0)
    )
    # seg_last: each segment's per_seg-th (largest extracted) value.
    seg_last = vals[..., per_seg - 1, :]  # [..., S]
    merged = vals.reshape(lead + (per_seg * segments,))

    total, count_m, kth = _smallest_k_sum_count(
        merged, jnp.isfinite(merged), k, None
    )
    # Certificate, two conditions:
    # 1. every segment's per_seg-th extracted value >= the kth overall
    #    (nothing smaller can remain un-extracted; an exhausted segment has
    #    +inf there). Ties are safe: equal values give an equal sum.
    # 2. as many values were extracted as the true top-k holds
    #    (min(k, full-width finite count)) — otherwise a deep segment kept
    #    part of the top-k while the others ran dry, and condition 1 alone
    #    would pass vacuously.
    ok = jnp.logical_and(
        jnp.all(seg_last >= kth[..., None], axis=-1),
        count_m >= jnp.minimum(k, count_all),
    )
    # count semantics match _smallest_k_sum_count: #extracted (<= k).
    return total, count_m, kth, ok


@partial(jax.jit, static_argnames=("k", "chunk"))
def cell_sor_mean_dists(
    grid: CellGrid,
    n_points: int | None = None,
    *,
    k: int,
    chunk: int = CELL_CHUNK,
):
    """Per-point mean distance to its k nearest non-self neighbors, computed
    cell-centrically (queries = each cell's own points). Returns
    (mean_dists f32[N] in ORIGINAL point order, point_ok bool[N],
    certified bool).

    Semantics match the reference SOR inner loop
    (ref: crates/filters/src/statistical_outlier.rs:19-39): self-match
    skipped, isolated / invalid points get +inf. ``point_ok`` is False for
    points whose result cannot be certified exact (kth-neighbor distance
    beyond one cell width, or fewer than k+1 candidates found) — callers
    recompute those with a coarser second pass (`cell_knn_subset`) or
    retry; ``certified`` is the global conjunction.
    """
    cell2 = cert_cell2(grid)
    caps = grid.cell_xyz.shape[0]

    # The reference requests k+1 neighbors and skips the first (self,
    # distance 0). Taking the k+1 smallest here includes that self hit,
    # which contributes 0 to the distance sum, so subtracting one from the
    # count reproduces the same mean.
    nch = _chunk_cells(grid, chunk)

    def chunk_fn(args):
        q, qm_c, slots = args  # [c, M, 3], [c, M], [c, 27]
        nb_xyz, nb_mask, _ = gather_neighbor_blocks(grid, slots)
        c, m27, m, _ = nb_xyz.shape
        nb_flat = nb_xyz.reshape(c, m27 * m, 3)
        nbm_flat = nb_mask.reshape(c, m27 * m)
        diff = q[:, :, None, :] - nb_flat[:, None, :, :]  # [c, M, 27M, 3]
        d2 = jnp.sum(diff * diff, axis=-1)
        pair_valid = jnp.logical_and(qm_c[:, :, None], nbm_flat[:, None, :])
        return _smallest_k_sum_count(d2, pair_valid, k + 1, None)

    totals, counts, kth_d2s = jax.lax.map(
        chunk_fn,
        (
            grid.cell_xyz.reshape(nch, chunk, -1, 3),
            grid.cell_mask.reshape(nch, chunk, -1),
            grid.neighbor_slots.reshape(nch, chunk, -1),
        ),
    )
    total = totals.reshape(caps, -1)
    count = counts.reshape(caps, -1)
    kth_d2 = kth_d2s.reshape(caps, -1)
    qm = grid.cell_mask

    n_neighbors = jnp.maximum(count - 1, 0)
    mean = jnp.where(
        n_neighbors > 0,
        total / jnp.maximum(n_neighbors.astype(jnp.float32), 1.0),
        jnp.inf,
    )  # [C, M]

    # A point with fewer than k+1 candidates in its search neighborhood
    # (but k+1 valid points existing globally) is isolated at the search
    # scale: averaging only the few near neighbors would make it look
    # *denser* than it is, inverting SOR's outlier test. Mark it not-ok so
    # the caller recomputes it at a coarser scale (mean stays +inf if never
    # resolved — the exact mean over the true far k-NN would exceed any
    # practical threshold too).
    n_valid_total = jnp.sum(grid.cell_mask.astype(jnp.int32))
    want = jnp.minimum(k + 1, n_valid_total)
    mean = jnp.where(count >= want, mean, jnp.inf)

    ok_q = jnp.logical_and(count >= want, kth_d2 <= cell2)
    uncertified = jnp.logical_and(qm, jnp.logical_not(ok_q))
    certified = jnp.logical_not(jnp.any(uncertified))

    # Scatter back to original point order.
    n = grid.point_slot.shape[0]
    flat_idx = grid.cell_idx.reshape(-1)
    flat_m = grid.cell_mask.reshape(-1)
    safe_idx = jnp.where(flat_m, flat_idx, n)
    out = (
        jnp.full((n + 1,), jnp.inf, jnp.float32)
        .at[safe_idx]
        .set(jnp.where(flat_m, mean.reshape(-1), jnp.inf), mode="drop")[:n]
    )
    # Points not present in any block (invalid or rank-truncated) are not
    # ok either — except invalid ones, which are final (+inf) by contract.
    point_ok = (
        jnp.zeros((n + 1,), bool)
        .at[safe_idx]
        .set(jnp.logical_and(flat_m, ok_q.reshape(-1)), mode="drop")[:n]
    )
    return out, point_ok, certified


@partial(jax.jit, static_argnames=("k",))
def cell_knn_subset(grid: CellGrid, qxyz, qrows, qvalid, *, k: int):
    """Per-query KNN mean distances for a small compacted subset of points
    against a (typically coarser) grid: the second pass that resolves
    points the cell-centric pass could not certify.

    qxyz f32[B, 3], qrows i32[B] original rows, qvalid bool[B].
    Returns (means f32[B], ok bool[B]) with the same semantics as
    `cell_sor_mean_dists` (self hit included in the k+1 extraction).
    """
    cap = grid.cell_xyz.shape[0]
    n = grid.point_slot.shape[0]
    slot = jnp.take(
        jnp.concatenate([grid.point_slot, jnp.array([cap], jnp.int32)]),
        jnp.minimum(qrows, n),
    )  # [B]
    nb = jnp.take(
        jnp.concatenate(
            [grid.neighbor_slots, jnp.full((1, grid.neighbor_slots.shape[1]), cap, jnp.int32)]
        ),
        jnp.minimum(slot, cap),
        axis=0,
    )  # [B, K]
    nb_xyz, nb_mask = gather_neighbor_xyzw(grid, nb)
    b, kk, m, _ = nb_xyz.shape
    nb_flat = nb_xyz.reshape(b, kk * m, 3)
    nbm_flat = jnp.logical_and(nb_mask.reshape(b, kk * m), qvalid[:, None])
    diff = nb_flat - qxyz[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    if k + 1 <= 32 and kk * m >= 512:
        # Segmented selection: 4 + ~k sweeps over a 512-wide merge instead
        # of k+1 full-width sweeps (the rescue pass re-streamed its
        # [B, 27M] work array 21 times from HBM). Rows failing the segment
        # certificate simply come back ok=False — the same uncertified
        # verdict this pass already produces for kth > cell width.
        total, count, kth_d2, seg_ok = _segmented_smallest_k(
            d2, nbm_flat, k + 1
        )
    else:
        total, count, kth_d2 = _smallest_k_sum_count(d2, nbm_flat, k + 1, None)
        seg_ok = jnp.ones(total.shape, bool)
    n_neighbors = jnp.maximum(count - 1, 0)
    mean = jnp.where(
        n_neighbors > 0,
        total / jnp.maximum(n_neighbors.astype(jnp.float32), 1.0),
        jnp.inf,
    )
    n_valid_total = jnp.sum(grid.cell_mask.astype(jnp.int32))
    want = jnp.minimum(k + 1, n_valid_total)
    mean = jnp.where(count >= want, mean, jnp.inf)
    cell2 = cert_cell2(grid)
    ok = jnp.logical_and(count >= want, kth_d2 <= cell2)
    ok = jnp.logical_and(ok, seg_ok)
    return mean, ok


@partial(jax.jit, static_argnames=("chunk",))
def cell_radius_neighbor_blocks(grid: CellGrid, radius, *, chunk: int = CELL_CHUNK):
    """Per-cell candidate blocks for radius queries: returns
    (nb_idx i32[C, 27M], within bool[C, M, 27M]) where ``within`` marks
    candidate j within ``radius`` (inclusive) of the cell's point i."""
    nch = _chunk_cells(grid, chunk)
    r2 = radius * radius

    def chunk_fn(args):
        q, qm, slots = args
        nb_xyz, nb_mask, nb_idx = gather_neighbor_blocks(grid, slots)
        c, m27, m, _ = nb_xyz.shape
        nb_flat = nb_xyz.reshape(c, m27 * m, 3)
        nbm_flat = nb_mask.reshape(c, m27 * m)
        diff = q[:, :, None, :] - nb_flat[:, None, :, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        within = jnp.logical_and(
            jnp.logical_and(qm[:, :, None], nbm_flat[:, None, :]),
            d2 <= r2,
        )
        return nb_idx.reshape(c, m27 * m), within

    caps = grid.cell_xyz.shape[0]
    m = grid.cell_xyz.shape[1]
    nb_idxs, withins = jax.lax.map(
        chunk_fn,
        (
            grid.cell_xyz.reshape(nch, chunk, -1, 3),
            grid.cell_mask.reshape(nch, chunk, -1),
            grid.neighbor_slots.reshape(nch, chunk, -1),
        ),
    )
    return (
        nb_idxs.reshape(caps, 27 * m),
        withins.reshape(caps, m, 27 * m),
    )


@jax.jit
def cell_propagate_labels(grid: CellGrid, nb_idx, within):
    """Connected-component labels via min-label propagation over per-cell
    candidate blocks + pointer jumping. Labels are original point rows;
    invalid points keep their own row. Returns i32[N]."""
    n = grid.point_slot.shape[0]
    init = jnp.arange(n, dtype=jnp.int32)
    big = jnp.int32(n)
    cell_rows = grid.cell_idx  # [C, M] original rows per cell slot
    cm = grid.cell_mask

    def body(state):
        labels, _ = state
        # labels of all candidates, per cell block
        cand_labels = jnp.take(
            jnp.concatenate([labels, jnp.array([big])]), nb_idx, axis=0
        )  # [C, 27M]
        cand_labels = jnp.where(
            within, cand_labels[:, None, :], big
        )  # [C, M, 27M] broadcast per query
        new_min = jnp.min(cand_labels, axis=-1)  # [C, M]
        own = jnp.take(
            jnp.concatenate([labels, jnp.array([big])]),
            jnp.where(cm, cell_rows, n),
            axis=0,
        )
        new_min = jnp.minimum(new_min, own)
        # scatter back
        upd = (
            jnp.full((n + 1,), big, jnp.int32)
            .at[jnp.where(cm, cell_rows, n)]
            .min(jnp.where(cm, new_min, big), mode="drop")[:n]
        )
        labels2 = jnp.minimum(labels, upd)
        # pointer jumping
        labels2 = jnp.minimum(labels2, jnp.take(labels2, labels2))
        labels2 = jnp.minimum(labels2, jnp.take(labels2, labels2))
        changed = jnp.any(labels2 != labels)
        return labels2, changed

    labels, _ = jax.lax.while_loop(
        lambda s: s[1], body, (init, jnp.asarray(True))
    )
    return labels


# ── Collapsed cell-graph clustering ──────────────────────────────────────────
#
# For euclidean clustering with threshold r, build the grid with
# cell_size <= r / sqrt(3) * sqrt(3)... practically cell = r/2 and ring = 2:
# the cell diagonal (r*sqrt(3)/2 < r) makes all points in one cell mutually
# connected, so each occupied cell collapses to a single graph node. The
# point-pair existence test between a cell and its 124 ring-2 neighbors is
# computed ONCE (not per propagation iteration), and min-label propagation
# runs on the tiny cell graph.


@partial(jax.jit, static_argnames=("chunk",))
def cell_graph_adjacency(grid: CellGrid, radius, *, chunk: int = 256):
    """bool[C, K] adjacency: does any point pair between cell c and its
    k-th ring-neighbor lie within ``radius`` (inclusive)?"""
    nch = _chunk_cells(grid, chunk)
    r2 = radius * radius

    def chunk_fn(args):
        q, qm, slots = args  # [c, M, 3], [c, M], [c, K]
        nb_xyz, nb_mask = gather_neighbor_xyzw(grid, slots)
        c, k, m, _ = nb_xyz.shape
        nb_flat = nb_xyz.reshape(c, k * m, 3)
        nbm_flat = nb_mask.reshape(c, k * m)
        diff = q[:, :, None, :] - nb_flat[:, None, :, :]  # [c, M, K*M, 3]
        d2 = jnp.sum(diff * diff, axis=-1)
        ok = jnp.logical_and(
            jnp.logical_and(qm[:, :, None], nbm_flat[:, None, :]), d2 <= r2
        )
        return jnp.any(ok.reshape(c, m, k, m), axis=(1, 3))  # [c, K]

    adj = jax.lax.map(
        chunk_fn,
        (
            grid.cell_xyz.reshape(nch, chunk, -1, 3),
            grid.cell_mask.reshape(nch, chunk, -1),
            grid.neighbor_slots.reshape(nch, chunk, -1),
        ),
    )
    return adj.reshape(grid.cell_xyz.shape[0], -1)


@jax.jit
def cell_graph_labels(grid: CellGrid, adjacency):
    """Min-label propagation + pointer jumping on the collapsed cell graph.
    Returns per-POINT labels i32[N] in original point order: the smallest
    original point row in each connected component (so labels are stable,
    comparable ids). Invalid points keep their own row (singletons)."""
    cap = grid.cell_xyz.shape[0]
    n = grid.point_slot.shape[0]
    big = jnp.int32(cap)

    nbr = jnp.where(adjacency, grid.neighbor_slots, big)  # [C, K]
    init = jnp.arange(cap, dtype=jnp.int32)

    def body(state):
        lab, _ = state
        labx = jnp.concatenate([lab, jnp.array([big])])
        nl = jnp.take(labx, nbr.reshape(-1), axis=0).reshape(nbr.shape)
        m = jnp.minimum(jnp.min(nl, axis=1), lab)
        mx = jnp.concatenate([m, jnp.array([big])])
        m = jnp.minimum(m, jnp.take(mx, m))
        mx = jnp.concatenate([m, jnp.array([big])])
        m = jnp.minimum(m, jnp.take(mx, m))
        return m, jnp.any(m != lab)

    cell_lab, _ = jax.lax.while_loop(
        lambda s: s[1], body, (init, jnp.asarray(True))
    )

    # Component representative = smallest original point row in the
    # component: scatter-min each cell's smallest member row onto its label.
    min_row = jnp.min(
        jnp.where(grid.cell_mask, grid.cell_idx, n), axis=1
    )  # [C]
    rep = (
        jnp.full((cap + 1,), n, jnp.int32)
        .at[cell_lab]
        .min(min_row, mode="drop")
    )
    cell_rep = jnp.take(rep, cell_lab)  # [C] representative per cell

    # Per-point labels: the representative of the point's cell; invalid
    # points (slot == cap) keep their own row.
    cell_rep_x = jnp.concatenate([cell_rep, jnp.array([n], jnp.int32)])
    plab = jnp.take(cell_rep_x, jnp.minimum(grid.point_slot, cap))
    own = jnp.arange(n, dtype=jnp.int32)
    return jnp.where(plab >= n, own, plab)


@partial(jax.jit, static_argnames=("k", "qchunk"))
def point_sor_mean_dists(
    grid: CellGrid, xyz, valid, *, k: int, qchunk: int = 4096,
):
    """Query-centric SOR means: per-POINT extraction over the point's own
    cell slab. Same contract as `cell_sor_mean_dists` (means, point_ok,
    certified) but with no per-cell query-slot padding:

    1. cell-centric slab materialization: each cell's 27 neighbor blocks
       gathered once ([C, 27] block slices — few, cheap);
    2. per-point slab fetch: one LARGE slice (27*M*3 floats) per point from
       the materialized slab — large-slice gathers run near HBM speed;
    3. extraction on [points, 27M] — the 21-pass min-extraction streams an
       array ~12x smaller than the cell-slot-padded formulation.
    """
    cap, m, _ = grid.cell_xyz.shape
    n = xyz.shape[0]
    km = grid.neighbor_slots.shape[1] * m
    cell2 = cert_cell2(grid)

    # Stage 1: materialize candidate slabs per cell, directly in flat 2D
    # layout ([C, 27*M*4]) — coordinates and validity packed so a single
    # gather fetches both, and no 4D intermediate picks up a tiled layout
    # that pads the small minor axis.
    nslots = grid.neighbor_slots
    flat = jnp.minimum(nslots, cap - 1).reshape(-1)
    absent = (nslots >= cap).reshape(-1)
    slab = jnp.take(grid.cell_xyzw.reshape(cap, m * 4), flat, axis=0)
    slab = slab.reshape(cap * km, 4)
    slab = jnp.where(
        jnp.repeat(absent, m)[:, None],
        jnp.array([0.0, 0.0, 0.0, -1.0], jnp.float32)[None, :],
        slab,
    ).reshape(cap, km * 4)

    # Stage 2+3: chunked per-point fetch + extraction.
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    q_use = jnp.logical_and(valid, finite)
    slot = jnp.minimum(grid.point_slot, cap - 1)
    in_grid = grid.point_slot < cap

    pad = (-n) % qchunk
    def padq(a, fill):
        if pad == 0:
            return a
        return jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)]
        )

    xyz_p = padq(xyz, 0.0)
    use_p = padq(jnp.logical_and(q_use, in_grid), False)
    slot_p = padq(slot, 0)
    nch = xyz_p.shape[0] // qchunk

    # The segment certificate's failure probability grows with k+1/segments;
    # past ~32 the flagged fraction would swamp the rescue pass.
    segmented = k + 1 <= 32

    def chunk_fn(args):
        qx, qu, qs = args
        row = jnp.take(slab, qs, axis=0).reshape(qchunk, km, 4)
        cand = row[..., :3]
        cv = jnp.logical_and(row[..., 3] >= 0.0, qu[:, None])
        diff = cand - qx[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        if segmented:
            # 4 segment sweeps + a 512-wide merge instead of k+1=21
            # full sweeps. The certificate passes only when no segment
            # held more than per_seg-1 of the strict top-k
            # (~128*P(Bin(21,1/128)>=4) ~ 0.3% flagged); flagged rows
            # come back ok=False and join the callers' rescue pass.
            return _segmented_smallest_k(d2, cv, k + 1)
        t, c, kd = _smallest_k_sum_count(d2, cv, k + 1, None)
        return t, c, kd, jnp.ones(t.shape, bool)

    totals, counts, kths, seg_oks = jax.lax.map(
        chunk_fn,
        (
            xyz_p.reshape(nch, qchunk, 3),
            use_p.reshape(nch, qchunk),
            slot_p.reshape(nch, qchunk),
        ),
    )
    total = totals.reshape(-1)[:n]
    count = counts.reshape(-1)[:n]
    kth_d2 = kths.reshape(-1)[:n]
    seg_ok = seg_oks.reshape(-1)[:n]

    n_neighbors = jnp.maximum(count - 1, 0)
    mean = jnp.where(
        n_neighbors > 0,
        total / jnp.maximum(n_neighbors.astype(jnp.float32), 1.0),
        jnp.inf,
    )
    n_valid_total = jnp.sum(grid.cell_mask.astype(jnp.int32))
    want = jnp.minimum(k + 1, n_valid_total)
    mean = jnp.where(count >= want, mean, jnp.inf)
    mean = jnp.where(q_use, mean, jnp.inf)

    point_ok = jnp.logical_and(count >= want, kth_d2 <= cell2)
    point_ok = jnp.logical_and(point_ok, seg_ok)
    point_ok = jnp.logical_and(point_ok, jnp.logical_and(q_use, in_grid))
    certified = jnp.logical_not(
        jnp.any(jnp.logical_and(q_use, jnp.logical_not(point_ok)))
    )
    return mean, point_ok, certified


# ── General (cross-cloud) pointwise queries ──────────────────────────────────
#
# Queries need not be the grid's own points: each query's 27 neighbor cells
# are found by direct dense-table lookups from its cell coordinates, then
# blocks are fetched per (query, cell) as packed xyzw slices.


def _query_neighbor_slots(grid: CellGrid, qxyz):
    """[Q, 27] neighbor cell slots for arbitrary query positions (cell_cap
    where absent/out of range)."""
    cap = grid.cell_xyz.shape[0]
    table_size = grid.table.shape[0] - 1
    c = jnp.floor(qxyz / grid.cell_size)
    c = jnp.clip(c, -1e9, 1e9).astype(jnp.int32)
    rel = c - grid.min_coord[None, :]
    noff = jnp.asarray(NEIGHBOR_OFFSETS)
    nrel = rel[:, None, :] + noff[None, :, :]  # [Q, 27, 3]
    in_bounds = jnp.all(
        jnp.logical_and(nrel >= 0, nrel < grid.extent[None, None, :]), axis=-1
    )
    nlin = (
        nrel[..., 0] * grid.extent[1] + nrel[..., 1]
    ) * grid.extent[2] + nrel[..., 2]
    nlin = jnp.where(in_bounds, nlin, table_size)
    slots = jnp.take(grid.table, nlin.reshape(-1), axis=0).reshape(nlin.shape)
    return jnp.where(slots < grid.num_cells, slots, cap)


@partial(jax.jit, static_argnames=("k", "qchunk"))
def point_knn(grid: CellGrid, qxyz, qvalid, *, k: int, qchunk: int = 2048):
    """K nearest neighbors per query over the 27-cell neighborhood.

    Returns (dists f32[Q, k] Euclidean ascending (+inf beyond results),
    idx i32[Q, k] original rows (0 where invalid), nvalid bool[Q, k],
    point_ok bool[Q]: per-query exactness certificate — found
    min(k, num_points) results AND the kth distance fits within one cell
    width; True for invalid queries, whose (empty) result is final).
    """
    n_q = qxyz.shape[0]
    cap, m, _ = grid.cell_xyzw.shape
    km = 27 * m
    cell2 = cert_cell2(grid)

    finite = jnp.all(jnp.isfinite(qxyz), axis=-1)
    q_use = jnp.logical_and(qvalid, finite)
    slots = _query_neighbor_slots(grid, jnp.where(finite[:, None], qxyz, 0.0))

    pad = (-n_q) % qchunk

    def padq(a, fill):
        if pad == 0:
            return a
        return jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)]
        )

    xyz_p = padq(qxyz, 0.0)
    use_p = padq(q_use, False)
    slots_p = padq(slots, cap)
    nch = xyz_p.shape[0] // qchunk
    kk = min(k, km)

    def chunk_fn(args):
        qx, qu, qs = args  # [q,3], [q], [q,27]
        flat = jnp.minimum(qs, cap - 1).reshape(-1)
        absent = (qs >= cap).reshape(-1)
        nb = jnp.take(grid.cell_xyzw.reshape(cap, m * 4), flat, axis=0)
        nb = nb.reshape(qchunk * 27, m, 4)
        nb = jnp.where(
            absent[:, None, None],
            jnp.array([0.0, 0.0, 0.0, -1.0], jnp.float32)[None, None, :],
            nb,
        ).reshape(qchunk, km, 4)
        cand = nb[..., :3]
        ids = nb[..., 3]
        cv = jnp.logical_and(ids >= 0.0, qu[:, None])
        diff = cand - qx[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        work = jnp.where(cv, d2, jnp.inf)
        found0 = jnp.sum(cv.astype(jnp.int32), axis=1)

        def body(j, state):
            work, dcols, icols = state
            am = jnp.argmin(work, axis=-1)
            mn = jnp.take_along_axis(work, am[:, None], axis=-1)[:, 0]
            mid = jnp.take_along_axis(ids, am[:, None], axis=-1)[:, 0]
            dcols = jax.lax.dynamic_update_index_in_dim(
                dcols, mn, j, axis=1
            )
            icols = jax.lax.dynamic_update_index_in_dim(
                icols, mid, j, axis=1
            )
            hit = (
                jnp.arange(work.shape[-1], dtype=jnp.int32) == am[:, None]
            )
            work = jnp.where(hit, jnp.inf, work)
            return work, dcols, icols

        dcols0 = jnp.full((qchunk, kk), jnp.inf, jnp.float32)
        icols0 = jnp.full((qchunk, kk), -1.0, jnp.float32)
        _, dcols, icols = jax.lax.fori_loop(
            0, kk, body, (work, dcols0, icols0)
        )
        return dcols, icols, found0

    d2s, idsf, founds = jax.lax.map(
        chunk_fn,
        (
            xyz_p.reshape(nch, qchunk, 3),
            use_p.reshape(nch, qchunk),
            slots_p.reshape(nch, qchunk, 27),
        ),
    )
    d2k = d2s.reshape(-1, kk)[:n_q]
    ids = idsf.reshape(-1, kk)[:n_q]
    found = founds.reshape(-1)[:n_q]

    nvalid = jnp.isfinite(d2k)
    dists = jnp.where(nvalid, jnp.sqrt(jnp.maximum(d2k, 0.0)), jnp.inf)
    idx = jnp.where(nvalid, ids, 0.0).astype(jnp.int32)

    n_pts = jnp.sum(grid.cell_mask.astype(jnp.int32))
    want = jnp.minimum(k, n_pts)
    kth_col = jnp.clip(want - 1, 0, kk - 1)
    kth_d2 = jnp.take(
        jnp.where(nvalid, d2k, jnp.inf), kth_col, axis=1
    )
    point_ok = jnp.logical_and(found >= want, kth_d2 <= cell2)
    point_ok = jnp.logical_or(point_ok, jnp.logical_not(q_use))
    if kk < k:  # fewer candidate slots than k: pad and let flags retry
        padc = k - kk
        dists = jnp.pad(dists, ((0, 0), (0, padc)), constant_values=jnp.inf)
        idx = jnp.pad(idx, ((0, 0), (0, padc)))
        nvalid = jnp.pad(nvalid, ((0, 0), (0, padc)))
        point_ok = jnp.zeros_like(point_ok)
    return dists, idx, nvalid, point_ok


@partial(jax.jit, static_argnames=("qchunk",))
def point_radius_count(grid: CellGrid, qxyz, qvalid, radius, *, qchunk: int = 4096):
    """Count of grid points within ``radius`` (inclusive) of each query.
    Exact iff radius <= cell_size and no block truncation (grid.overflow)."""
    n_q = qxyz.shape[0]
    cap, m, _ = grid.cell_xyzw.shape
    km = 27 * m
    r2 = radius * radius

    finite = jnp.all(jnp.isfinite(qxyz), axis=-1)
    q_use = jnp.logical_and(qvalid, finite)
    slots = _query_neighbor_slots(grid, jnp.where(finite[:, None], qxyz, 0.0))

    pad = (-n_q) % qchunk

    def padq(a, fill):
        if pad == 0:
            return a
        return jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)]
        )

    xyz_p = padq(qxyz, 0.0)
    use_p = padq(q_use, False)
    slots_p = padq(slots, cap)
    nch = xyz_p.shape[0] // qchunk

    def chunk_fn(args):
        qx, qu, qs = args
        flat = jnp.minimum(qs, cap - 1).reshape(-1)
        absent = (qs >= cap).reshape(-1)
        nb = jnp.take(grid.cell_xyzw.reshape(cap, m * 4), flat, axis=0)
        nb = nb.reshape(qchunk * 27, m, 4)
        nb = jnp.where(
            absent[:, None, None],
            jnp.array([0.0, 0.0, 0.0, -1.0], jnp.float32)[None, None, :],
            nb,
        ).reshape(qchunk, km, 4)
        cv = jnp.logical_and(nb[..., 3] >= 0.0, qu[:, None])
        diff = nb[..., :3] - qx[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        ok = jnp.logical_and(cv, d2 <= r2)
        return jnp.sum(ok.astype(jnp.int32), axis=1)

    counts = jax.lax.map(
        chunk_fn,
        (
            xyz_p.reshape(nch, qchunk, 3),
            use_p.reshape(nch, qchunk),
            slots_p.reshape(nch, qchunk, 27),
        ),
    )
    return counts.reshape(-1)[:n_q]


@partial(jax.jit, static_argnames=("k", "qchunk"))
def slab_knn(grid: CellGrid, qxyz, qvalid, *, k: int, qchunk: int = 4096):
    """Same-cloud KNN via the two-stage slab pattern (see
    point_sor_mean_dists): per-cell candidate slabs materialized once with
    block-granular gathers, then one LARGE slice per point — an order of
    magnitude faster than the per-(query, cell) gather in `point_knn`.
    Queries must be the grid's own points (point_slot lookup).

    Returns (dists f32[Q,k], idx i32[Q,k], nvalid bool[Q,k],
    point_ok bool[Q]).
    """
    cap, m, _ = grid.cell_xyzw.shape
    n = qxyz.shape[0]
    km = grid.neighbor_slots.shape[1] * m
    cell2 = cert_cell2(grid)
    kk = min(k, km)

    nslots = grid.neighbor_slots
    flat = jnp.minimum(nslots, cap - 1).reshape(-1)
    absent = (nslots >= cap).reshape(-1)
    slab = jnp.take(grid.cell_xyzw.reshape(cap, m * 4), flat, axis=0)
    slab = slab.reshape(cap * nslots.shape[1], m, 4)
    slab = jnp.where(
        absent[:, None, None],
        jnp.array([0.0, 0.0, 0.0, -1.0], jnp.float32)[None, None, :],
        slab,
    ).reshape(cap, km * 4)

    finite = jnp.all(jnp.isfinite(qxyz), axis=-1)
    q_use = jnp.logical_and(qvalid, finite)
    in_grid = grid.point_slot < cap
    slot = jnp.minimum(grid.point_slot, cap - 1)

    pad = (-n) % qchunk

    def padq(a, fill):
        if pad == 0:
            return a
        return jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)]
        )

    xyz_p = padq(qxyz, 0.0)
    use_p = padq(jnp.logical_and(q_use, in_grid), False)
    slot_p = padq(slot, 0)
    nch = xyz_p.shape[0] // qchunk

    def chunk_fn(args):
        qx, qu, qs = args
        row = jnp.take(slab, qs, axis=0).reshape(qchunk, km, 4)
        cand = row[..., :3]
        ids = row[..., 3]
        cv = jnp.logical_and(ids >= 0.0, qu[:, None])
        diff = cand - qx[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        work = jnp.where(cv, d2, jnp.inf)
        found0 = jnp.sum(cv.astype(jnp.int32), axis=1)

        def body(j, state):
            work, dcols, icols = state
            am = jnp.argmin(work, axis=-1)
            mn = jnp.take_along_axis(work, am[:, None], axis=-1)[:, 0]
            mid = jnp.take_along_axis(ids, am[:, None], axis=-1)[:, 0]
            dcols = jax.lax.dynamic_update_index_in_dim(dcols, mn, j, axis=1)
            icols = jax.lax.dynamic_update_index_in_dim(icols, mid, j, axis=1)
            hit = jnp.arange(work.shape[-1], dtype=jnp.int32) == am[:, None]
            work = jnp.where(hit, jnp.inf, work)
            return work, dcols, icols

        dcols0 = jnp.full((qchunk, kk), jnp.inf, jnp.float32)
        _, dcols, icols = jax.lax.fori_loop(
            0, kk, body,
            (work, dcols0, jnp.full((qchunk, kk), -1.0, jnp.float32)),
        )
        return dcols, icols, found0

    d2s, idsf, founds = jax.lax.map(
        chunk_fn,
        (
            xyz_p.reshape(nch, qchunk, 3),
            use_p.reshape(nch, qchunk),
            slot_p.reshape(nch, qchunk),
        ),
    )
    d2k = d2s.reshape(-1, kk)[:n]
    ids = idsf.reshape(-1, kk)[:n]
    found = founds.reshape(-1)[:n]

    nvalid = jnp.isfinite(d2k)
    dists = jnp.where(nvalid, jnp.sqrt(jnp.maximum(d2k, 0.0)), jnp.inf)
    idx = jnp.where(nvalid, ids, 0.0).astype(jnp.int32)

    n_pts = jnp.sum(grid.cell_mask.astype(jnp.int32))
    want = jnp.minimum(k, n_pts)
    kth_col = jnp.clip(want - 1, 0, kk - 1)
    kth_d2 = jnp.take(jnp.where(nvalid, d2k, jnp.inf), kth_col, axis=1)
    point_ok = jnp.logical_and(
        jnp.logical_and(found >= want, kth_d2 <= cell2),
        jnp.logical_and(q_use, in_grid),
    )
    point_ok = jnp.logical_or(point_ok, jnp.logical_not(q_use))
    if kk < k:
        padc = k - kk
        dists = jnp.pad(dists, ((0, 0), (0, padc)), constant_values=jnp.inf)
        idx = jnp.pad(idx, ((0, 0), (0, padc)))
        nvalid = jnp.pad(nvalid, ((0, 0), (0, padc)))
        point_ok = jnp.zeros_like(point_ok)
    return dists, idx, nvalid, point_ok
