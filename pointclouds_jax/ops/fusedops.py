"""Single-dispatch fused API ops: sweep + exact rescue + epilogue in ONE
XLA program.

The multi-dispatch engine paths (spatial/engine.py) certify exactness with
host round-trips: an extent sync to size the cell, the sweep dispatch, a
flag transfer, a host-compacted rescue dispatch, a merge, then the keep-
mask + compaction dispatches, and each hop costs a host sync.

This module folds the full op into one jitted program:

1. the grid cell size is estimated IN-GRAPH (same density math as
   `engine.estimate_cell_size`, f32 on device);
2. the sorted-window sweep runs exactly as before;
3. flagged rows are compacted in-graph (one stable payload sort into a
   static `cap` buffer — see `_flagged_rows`) and re-resolved by the
   unconditionally-exact tiled brute subset used by the engine's rescue;
4. the op epilogue (SOR keep mask / radius-count threshold / normals
   orientation) and the output compaction run in the same program.

One dispatch, one host sync (a small packed info vector rides out with
the result). Exactness is preserved: the info vector carries
``exact = n_flagged <= cap``; the rare overflow (dense adversarial
clouds) falls back to the engine's multi-dispatch path, so results are
identical to the reference KD-tree semantics in every case
(ref: crates/filters/src/statistical_outlier.rs:19-39,
crates/filters/src/radius_outlier.rs:4-18,
crates/normals/src/estimate.rs:42-107).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import cloud as _cloud
from ..spatial.knn import (
    bruteforce_knn,
    bruteforce_radius_count,
)
from ..spatial.engine import _brute_sor_means
from .filters import (
    passthrough_mask,
    sor_keep_mask,
    sor_mean_dists_from_knn,
    voxel_downsample_masked,
)
from .normals import normals_from_knn, normals_from_moment_rows


def fused_rescue_cap(n: int) -> int:
    """Static in-graph rescue capacity: the brute subset costs O(cap * N)
    exact distances, so scale it with the cloud but bound the worst case
    (4096 x 1M ~ 25 GFLOP at HIGHEST ~ a few ms)."""
    return min(max(512, n // 32), 4096)


def _cell_estimate_device(xyz, valid, kf):
    """In-graph mirror of `engine.estimate_cell_size`: blended 3D/2D
    density estimate of the kth-NN distance, 1.25x margin."""
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    use = jnp.logical_and(valid, finite)
    big = jnp.float32(jnp.inf)
    mn = jnp.min(jnp.where(use[:, None], xyz, big), axis=0)
    mx = jnp.max(jnp.where(use[:, None], xyz, -big), axis=0)
    n = jnp.sum(use.astype(jnp.float32))
    nf = jnp.maximum(n, 1.0)
    span = jnp.maximum(mx - mn, 1e-12)
    vol = span[0] * span[1] * span[2]
    sspan = jnp.sort(span)
    area = sspan[1] * sspan[2]
    s3 = (vol / nf) ** (1.0 / 3.0)
    s2 = jnp.sqrt(area / nf)
    r3 = s3 * (3.0 * kf / (4.0 * jnp.pi)) ** (1.0 / 3.0)
    r2 = s2 * jnp.sqrt(kf / jnp.pi)
    est = jnp.maximum(jnp.maximum(r3, r2), 1e-9) * 1.25
    return jnp.where(n < 1.0, jnp.float32(1.0), est.astype(jnp.float32))


def _flagged_rows(residual, cap: int):
    """In-graph compaction of flagged rows into a static-cap buffer.
    Returns (rows i32[cap] (fill = n, the scatter drop index),
    sub_valid bool[cap], nflag i32).

    compaction_order (one payload sort) instead of jnp.nonzero with a
    static size."""
    n = residual.shape[0]
    nflag = jnp.sum(residual.astype(jnp.int32))
    order = _cloud.compaction_order(residual)[:cap].astype(jnp.int32)
    sub_valid = jnp.arange(cap, dtype=jnp.int32) < nflag
    rows = jnp.where(sub_valid, order, n)
    return rows, sub_valid, nflag


# ── SOR ──────────────────────────────────────────────────────────────────────


@partial(jax.jit, static_argnames=("k", "wr", "cap"))
def sor_fused(arrs, std_mul, *, k: int, wr: int, cap: int):
    """statistical_outlier_removal in one dispatch.

    Returns (compacted CloudArrays, info i32[2] = [new_count, exact]).
    ``exact`` is 0 only when more than ``cap`` rows failed both the sweep
    and its AABB-pruned in-graph rescue — the caller then reruns the
    multi-dispatch engine path.
    """
    from ..spatial.sweep import sweep_sor_two_pass

    xyz, valid = arrs.xyz, arrs.valid
    n = xyz.shape[0]
    cell = _cell_estimate_device(xyz, valid, jnp.float32(k + 1))
    mean, ok, _ = sweep_sor_two_pass(xyz, valid, cell, k=k, wr=wr)
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    residual = jnp.logical_and(
        jnp.logical_and(valid, finite), jnp.logical_not(ok)
    )
    rows, sub_valid, nflag = _flagged_rows(residual, cap)
    sub_xyz = jnp.take(xyz, jnp.minimum(rows, n - 1), axis=0)
    sd, _, sv = bruteforce_knn(xyz, valid, sub_xyz, sub_valid, k + 1)
    sub_means = sor_mean_dists_from_knn(
        sd, sv, jnp.all(jnp.isfinite(sub_xyz), axis=-1)
    )
    mean = mean.at[rows].set(
        jnp.where(sub_valid, sub_means, 0.0), mode="drop"
    )
    exact = nflag <= cap
    keep = sor_keep_mask(mean, valid, std_mul)
    out = _cloud.compact(_cloud.mask_cloud(arrs, keep))
    cnt = _cloud.count(out)
    return out, jnp.stack([cnt, exact.astype(jnp.int32)])


@partial(jax.jit, static_argnames=("k",))
def sor_fused_small(arrs, std_mul, *, k: int):
    """Small-cloud SOR: unconditionally-exact brute KNN, one dispatch."""
    mean = _brute_sor_means(arrs.xyz, arrs.valid, k)
    keep = sor_keep_mask(mean, arrs.valid, std_mul)
    out = _cloud.compact(_cloud.mask_cloud(arrs, keep))
    cnt = _cloud.count(out)
    return out, jnp.stack([cnt, jnp.int32(1)])


# ── Radius outlier removal ───────────────────────────────────────────────────


@partial(jax.jit, static_argnames=("wr", "cap"))
def ror_fused(arrs, radius, min_neighbors, *, wr: int, cap: int):
    """radius_outlier_removal in one dispatch (count includes self,
    inclusive boundary — ref: crates/filters/src/radius_outlier.rs:4-18)."""
    from ..spatial.sweep import sweep_radius_count_two_pass

    xyz, valid = arrs.xyz, arrs.valid
    n = xyz.shape[0]
    # Pass 1 windowed count + in-graph AABB-group-pruned exact rescue of
    # window-overflow rows (no distance certificate needed: the prune
    # ball IS the query radius).
    counts, ok = sweep_radius_count_two_pass(
        xyz, valid, radius, fix_cap=cap, wr=wr
    )
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    residual = jnp.logical_and(
        jnp.logical_and(valid, finite), jnp.logical_not(ok)
    )
    rows, sub_valid, nflag = _flagged_rows(residual, cap)
    sub_counts = bruteforce_radius_count(
        xyz,
        valid,
        jnp.take(xyz, jnp.minimum(rows, n - 1), axis=0),
        sub_valid,
        radius,
    ).astype(jnp.int32)
    counts = counts.at[rows].set(
        jnp.where(sub_valid, sub_counts, 0), mode="drop"
    )
    exact = nflag <= cap
    keep = jnp.logical_and(valid, counts >= min_neighbors)
    out = _cloud.compact(_cloud.mask_cloud(arrs, keep))
    cnt = _cloud.count(out)
    return out, jnp.stack([cnt, exact.astype(jnp.int32)])


@jax.jit
def ror_fused_small(arrs, radius, min_neighbors):
    counts = bruteforce_radius_count(
        arrs.xyz, arrs.valid, arrs.xyz, arrs.valid, radius
    ).astype(jnp.int32)
    keep = jnp.logical_and(arrs.valid, counts >= min_neighbors)
    out = _cloud.compact(_cloud.mask_cloud(arrs, keep))
    cnt = _cloud.count(out)
    return out, jnp.stack([cnt, jnp.int32(1)])


# ── Normals ──────────────────────────────────────────────────────────────────


@partial(jax.jit, static_argnames=("k", "wr", "cap"))
def normals_fused(xyz, valid, viewpoint, *, k: int, wr: int, cap: int):
    """estimate_normals in one dispatch: KNN-moments sweep + exact
    brute rescue + Cardano + orientation. Returns (normals f32[N,3],
    exact i32[])."""
    from ..spatial.sweep import sweep_moments_two_pass_rows

    n = xyz.shape[0]
    vp = jnp.asarray(viewpoint, jnp.float32)
    cell = _cell_estimate_device(xyz, valid, jnp.float32(k))
    # Pass 1 windowed moments + in-graph AABB-group-pruned exact rescue;
    # the whole-cloud rescue below then only sees the rare
    # isolated-beyond-4-cells remainder. Row layout end-to-end: the only
    # [N, 3] is the output stack.
    m1r, m2r, cnt, ok = sweep_moments_two_pass_rows(
        xyz, valid, cell, k=k, fix_cap=cap, wr=wr
    )
    nrm = normals_from_moment_rows(m1r, m2r, cnt, xyz, vp)
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    residual = jnp.logical_and(
        jnp.logical_and(valid, finite), jnp.logical_not(ok)
    )
    rows, sub_valid, nflag = _flagged_rows(residual, cap)
    sub_xyz = jnp.take(xyz, jnp.minimum(rows, n - 1), axis=0)
    sd, si, sv = bruteforce_knn(xyz, valid, sub_xyz, sub_valid, k)
    sub_n = normals_from_knn(xyz, si, sv, vp, query_xyz=sub_xyz)
    nrm = nrm.at[rows].set(
        jnp.where(sub_valid[:, None], sub_n, 0.0), mode="drop"
    )
    return nrm, (nflag <= cap).astype(jnp.int32)


@partial(jax.jit, static_argnames=("k",))
def normals_fused_small(xyz, valid, viewpoint, *, k: int):
    vp = jnp.asarray(viewpoint, jnp.float32)
    dists, idx, nvalid = bruteforce_knn(xyz, valid, xyz, valid, k)
    return normals_from_knn(xyz, idx, nvalid, vp), jnp.int32(1)


# ── Same-cloud KNN ───────────────────────────────────────────────────────────


@partial(jax.jit, static_argnames=("k", "wr", "cap"))
def knn_fused(xyz, valid, *, k: int, wr: int, cap: int):
    """Whole-cloud KNN (self included) in one dispatch: sweep + exact
    brute rescue. Returns (dists, idx, nvalid, exact i32[])."""
    from ..spatial.sweep import sweep_knn_two_pass

    n = xyz.shape[0]
    cell = _cell_estimate_device(xyz, valid, jnp.float32(k))
    # Pass 1 sweep + in-graph AABB-group-pruned exact rescue; the
    # whole-cloud rescue below only sees the isolated remainder.
    d, i, nv, ok = sweep_knn_two_pass(
        xyz, valid, cell, k=k, fix_cap=cap, wr=wr
    )
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    residual = jnp.logical_and(
        jnp.logical_and(valid, finite), jnp.logical_not(ok)
    )
    rows, sub_valid, nflag = _flagged_rows(residual, cap)
    d3, i3, v3 = bruteforce_knn(
        xyz, valid, jnp.take(xyz, jnp.minimum(rows, n - 1), axis=0),
        sub_valid, k,
    )
    d = d.at[rows].set(jnp.where(sub_valid[:, None], d3, 0.0), mode="drop")
    i = i.at[rows].set(
        jnp.where(sub_valid[:, None], i3.astype(i.dtype), 0), mode="drop"
    )
    nv = nv.at[rows].set(
        jnp.where(sub_valid[:, None], v3, False), mode="drop"
    )
    return d, i, nv, (nflag <= cap).astype(jnp.int32)


# ── Passthrough / voxel (mask + compact + count in one program) ─────────────


@partial(jax.jit, static_argnames=("axis_index",))
def passthrough_fused(arrs, axis_index: int, lo, hi):
    keep = passthrough_mask(arrs.xyz, arrs.valid, axis_index, lo, hi)
    out = _cloud.compact(_cloud.mask_cloud(arrs, keep))
    return out, _cloud.count(out)


@jax.jit
def voxel_fused(xyz, valid, voxel_size):
    """Voxel centroids + count in one program. Output voxels are already
    emitted leading-compact in sorted-key order by
    voxel_downsample_masked, so no compaction pass is needed."""
    centroids, out_valid = voxel_downsample_masked(xyz, valid, voxel_size)
    arrs = _cloud.CloudArrays(xyz=centroids, valid=out_valid)
    return arrs, jnp.sum(out_valid.astype(jnp.int32))
