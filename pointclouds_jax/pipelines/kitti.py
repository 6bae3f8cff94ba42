"""Fused KITTI obstacle-detection pipeline: one XLA program end-to-end.

The reference runs the 5-step pipeline as separate Rust calls with a
Python<->Rust array copy per step (examples/python/kitti_obstacle_detection.py:87-122).
Here the whole chain — voxel downsample -> statistical outlier removal ->
RANSAC ground plane -> ground removal -> euclidean clustering — compiles to
a single jitted program: the array enters the device once per frame and only
cluster labels come back.

Fused-path SOR neighbor search note: inside one jit there is no host retry
loop, so KNN candidates are searched by the sorted-window sweep at a fixed
cell size (``sor_cell_factor`` voxels) with an in-graph AABB-pruned exact
rescue of the rows pass 1 cannot certify. Points isolated beyond the
rescue radius keep upper-bound means and are removed — which is SOR's
purpose — and `sor_certified` proves every keep/remove decision. The
standalone `statistical_outlier_removal` API keeps exact KD-tree-parity
semantics via the host retry engine; `tests/test_pipeline.py` validates
that the fused path reproduces the exact path's output on KITTI-style
scenes.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.cloud import compaction_order
from ..ops.filters import (
    sor_keep_mask_thr,
    voxel_downsample_masked,
    voxel_downsample_sweep_fused,
)
from ..ops.segmentation import ransac_plane_masked
from ..spatial.sweep import (
    structure_from_sorted,
    sweep_cluster_labels,
    sweep_sor_two_pass,
)

# The one neighbor engine the fused pipelines run on.
BACKENDS = ("sweep",)


def check_backend(backend: str) -> None:
    """Raise ValueError for any backend name other than the sweep engine."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; the pipelines run on {BACKENDS}"
        )


class KittiPipelineOutput(NamedTuple):
    centroids: jax.Array  # f32[N, 3] voxel centroids (padded)
    downsampled_valid: jax.Array  # bool[N]
    cleaned_valid: jax.Array  # bool[N] after SOR
    plane_normal: jax.Array  # f32[3]
    plane_d: jax.Array  # f32
    inlier_mask: jax.Array  # bool[N] ground-plane inliers (of cleaned)
    obstacle_src: jax.Array  # i32[CAP] rows into centroids for obstacles
    obstacle_valid: jax.Array  # bool[CAP]
    labels: jax.Array  # i32[CAP] cluster labels over obstacle slots
    obstacle_overflow: jax.Array  # bool: more obstacles than CAP
    sor_certified: jax.Array  # bool: SOR neighbor search certified exact
    grid_flags: jax.Array  # bool[5]: [0, 0, cluster inexact, 0, ds overflow]


@partial(
    jax.jit,
    static_argnames=(
        "sor_k",
        "ransac_iters",
        "obstacle_cap",
        "sor_fix_cap",
        "sor_backend",
        "ds_cap",
        "ransac_subsample",
        "sor_cell_factor",
        "sor_per_seg",
        "cluster_wr",
    ),
)
def kitti_obstacle_pipeline(
    xyz,
    valid,
    voxel_size,
    sor_std,
    ransac_thresh,
    seed,
    cluster_r,
    *,
    sor_k: int = 20,
    ransac_iters: int = 500,
    obstacle_cap: int = 16384,
    # 4096: with priority rescue + the decision certificate the rescue
    # only needs the no-lower-bound rows (~2.4K at the bench operating
    # point); cap adequacy is PROVEN per frame by sor_certified.
    sor_fix_cap: int = 4096,
    sor_backend: str = "sweep",
    ds_cap: int | None = None,
    ransac_subsample: int | None = None,
    sor_cell_factor: float = 3.0,
    sor_per_seg: int = 2,
    cluster_wr: int = 12,
):
    check_backend(sor_backend)
    # ── Step 1: voxel downsample ────────────────────────────────────────────
    if ds_cap is None:
        ds_cap = xyz.shape[0]
    # Shared front end: the voxel stage emits (bitwise-identical) centroids
    # whose compacted rows are then sorted ONCE into sor-cell-major sweep
    # order, and the SOR structure is built directly on them (identity
    # permutation) — no inverse-permutation sort, no unsort gather, and
    # RANSAC's compaction sort is replaced by the cheaper canonical
    # mini-sort below. The voxel segmented scan stays
    # in CANONICAL key order so its f32 combine tree — and therefore every
    # centroid value — is bitwise identical to voxel_downsample_masked's.
    fused_frontend = (
        float(sor_cell_factor).is_integer() and ds_cap % 128 == 0
    )
    prebuilt = None
    canon = None
    if fused_frontend:
        factor = int(sor_cell_factor)
        fe = voxel_downsample_sweep_fused(
            xyz, valid, voxel_size, factor=factor, ds_cap=ds_cap,
        )
        centroids, ds_valid = fe["centroids"], fe["out_valid"]
        canon = fe["canon"]
        ds_overflow = fe["ds_overflow"]
        prebuilt = structure_from_sorted(
            centroids,
            ds_valid,
            fe["slin"],
            fe["extent"],
            fe["hi_cells"],
            fe["table_overflow"],
            wr=4,
            # Voxel-lattice origin: pass 1 certifies with the per-query
            # coverage radius (1.0-1.5 cells) instead of the worst-case
            # cell width — several-fold fewer flagged rows.
            grid_origin=(fe["mn_v"], voxel_size, factor),
        )
    else:
        centroids_full, ds_valid_full = voxel_downsample_masked(
            xyz, valid, voxel_size
        )
        # Voxel output is compacted (valid rows first, ascending cell key).
        # The default capacity keeps every voxel (honest workload: real
        # Velodyne frames at 0.15 m voxels only shrink ~1.3x); callers
        # processing heavily redundant clouds can pass a smaller ds_cap to
        # cut downstream work (ds_overflow in grid_flags[4] reports
        # truncation; bench.py checks it).
        centroids = centroids_full[:ds_cap]
        ds_valid = ds_valid_full[:ds_cap]
        ds_overflow = jnp.any(ds_valid_full[ds_cap:])

    # ── Step 2: statistical outlier removal (sweep + exact rescue) ─────────
    # Pass 1: cell = sor_cell_factor voxels — the k=20th-neighbor radius at
    # production densities (22-45 pts/m^2 ground) stays inside one cell
    # width, so only genuinely sparse points (noise, object borders) fail
    # the certificate, keeping the pass-2 rescue batch under its cap.
    # Pass 2 (inside sweep_sor_two_pass) is the exact AABB-pruned brute
    # rescue; it certifies up to `rescue_cells` cell widths, and points
    # isolated beyond that keep upper-bound means and uncertified status.
    sor_cell = voxel_size * sor_cell_factor
    mean_dists, point_ok, sor_certified, mean_lb = sweep_sor_two_pass(
        centroids,
        ds_valid,
        sor_cell,
        k=sor_k,
        fix_cap=sor_fix_cap,
        # 8 cells: the count-short lower bound (total + missing*R)/k must
        # clear any practical keep threshold — at 4 cells the sparse
        # rows' removal stayed unprovable (R=1.8 m < thr).
        rescue_cells=8.0,
        per_seg=sor_per_seg,  # 2 = one fewer insertion level; the extra
        # segment-certificate flags are rescued exactly
        prebuilt=prebuilt,
        with_lb=True,
    )
    cleaned_valid, sor_thr = sor_keep_mask_thr(mean_dists, ds_valid, sor_std)
    # Keep-DECISION certificate: a query is decision-certified when its
    # mean is exact (point_ok), OR its upper-bound mean already passes the
    # keep test (true mean <= UB <= thr => keep correct), OR its PROVEN
    # lower bound exceeds the threshold (true mean >= LB > thr => removal
    # correct — this is the isolated-point argument folded into the
    # certificate: candidates are complete within the coverage/rescue
    # radius, so the missing neighbors are each provably farther). The
    # threshold is the computed one (flagged rows contribute upper-bound
    # means to mu/sigma; the external f64 oracle replay,
    # scripts/verify_kitti_parity.py, independently validates the
    # measured frame end-to-end).
    decision_ok = jnp.logical_or(
        jnp.logical_or(point_ok, cleaned_valid),
        mean_lb.astype(jnp.float64) > sor_thr,
    )
    sor_certified = jnp.all(
        jnp.logical_or(decision_ok, jnp.logical_not(ds_valid))
    )

    # ── Step 3: RANSAC ground plane ────────────────────────────────────────
    # ransac_subsample: tournament scoring (subsample + top-8 full-cloud
    # rescore, see ops/segmentation.py) — A/B lever for the streaming
    # bench; the final inlier set is always full-cloud.
    position_rows = None
    if canon is not None:
        # Canonical mini-sort: position p -> the row holding the p-th
        # cleaned centroid in CANONICAL voxel-key order — exactly the row
        # the per-op path samples at position p, so RANSAC hypothesis
        # selection is identical to `pc.ransac_plane_seeded` on the
        # compacted cleaned cloud (tests/test_pipeline.py's parity gate).
        ckey = jnp.where(cleaned_valid, canon, jnp.int32(2**31 - 1))
        _, position_rows = jax.lax.sort(
            (ckey, jnp.arange(ckey.shape[0], dtype=jnp.int32)),
            num_keys=1,
            is_stable=True,
        )
    normal, d, inlier_mask = ransac_plane_masked(
        centroids, cleaned_valid, ransac_thresh, seed, ransac_iters,
        score_subsample=ransac_subsample,
        # Same reference-dispatch rule as the per-op API path (adaptive
        # early termination below 10K valid points) — keeps the
        # pipeline-vs-API winner parity gate exact at test scales.
        adaptive=(ransac_subsample is None),
        position_rows=position_rows,
    )

    # ── Step 4: ground removal + compact obstacles to a small capacity ─────
    obstacle_mask = jnp.logical_and(cleaned_valid, jnp.logical_not(inlier_mask))
    if canon is not None:
        # Slots must come out in CANONICAL voxel order (slot index == row
        # of the per-op path's select_inverse sub-cloud — the
        # extract_clusters contract), not in the sweep frame's row order.
        okey = jnp.where(obstacle_mask, canon, jnp.int32(2**31 - 1))
        _, order = jax.lax.sort(
            (okey, jnp.arange(okey.shape[0], dtype=jnp.int32)),
            num_keys=1,
            is_stable=True,
        )
    else:
        order = compaction_order(obstacle_mask)
    obs_src = order[:obstacle_cap].astype(jnp.int32)
    obs_valid = jnp.take(obstacle_mask, obs_src)
    obs_xyz = jnp.take(centroids, obs_src, axis=0)
    n_obstacles = jnp.sum(obstacle_mask.astype(jnp.int32))
    overflow = n_obstacles > obstacle_cap

    # ── Step 5: euclidean clustering ───────────────────────────────────────
    # Sweep min-label propagation directly on the cell-sorted obstacle
    # points (3-5 hop+pointer-jump iterations): no cell grid, no [C, 125]
    # adjacency matrix. cluster_exact=False (window overflow / iteration
    # cap) surfaces in grid_flags[2] — callers needing guaranteed-exact
    # clusters then rerun via the engine path.
    # wr=12: at the default wr=7 one dense obstacle block's 9-window span
    # overflows on real Velodyne frames (cars are ~100 pts/cell at 0.15 m
    # voxels), tripping the exactness certificate.
    labels, cluster_exact = sweep_cluster_labels(
        obs_xyz, obs_valid, cluster_r, wr=cluster_wr
    )
    no = jnp.asarray(False)

    return KittiPipelineOutput(
        centroids=centroids,
        downsampled_valid=ds_valid,
        cleaned_valid=cleaned_valid,
        plane_normal=normal,
        plane_d=d,
        inlier_mask=inlier_mask,
        obstacle_src=obs_src,
        obstacle_valid=obs_valid,
        labels=labels,
        obstacle_overflow=overflow,
        sor_certified=sor_certified,
        grid_flags=jnp.stack(
            [no, no, jnp.logical_not(cluster_exact), no, ds_overflow]
        ),
    )


def extract_clusters(out: KittiPipelineOutput, min_size: int, max_size: int):
    """Host-side cluster extraction with the reference's canonical ordering
    (size desc, lexicographic tiebreak; ascending indices within a cluster).
    Indices refer to the obstacle sub-cloud in compacted obstacle order,
    matching `cleaned.select_inverse(plane.inliers)` row numbering."""
    import numpy as np

    labels = np.asarray(out.labels)
    obs_valid = np.asarray(out.obstacle_valid)
    # Obstacle slot i corresponds to the i-th obstacle in original order
    # (compaction is stable), so slot index == row in the select_inverse
    # sub-cloud.
    valid_slots = np.nonzero(obs_valid)[0]
    lab = labels[valid_slots]
    order = np.argsort(lab, kind="stable")
    sl = lab[order]
    starts = np.nonzero(np.concatenate([[True], sl[1:] != sl[:-1]]))[0]
    ends = np.concatenate([starts[1:], [len(sl)]])
    clusters = []
    slot_rank = {s: i for i, s in enumerate(valid_slots)}
    for s, e in zip(starts, ends):
        size = e - s
        if min_size <= size <= max_size:
            members = np.sort(valid_slots[order[s:e]])
            clusters.append([slot_rank[m] for m in members])
    clusters.sort(key=lambda c: (-len(c), c))
    return clusters
