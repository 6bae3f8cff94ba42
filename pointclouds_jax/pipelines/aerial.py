"""Fused aerial-LiDAR pipeline: one XLA program end-to-end.

The reference aerial demo (examples/python/aerial_lidar.py:143-186) runs
voxel downsample (0.5 m) -> normal estimation (k = 15) -> RANSAC ground
plane (0.3, 300) -> ground removal -> euclidean clustering (r = 2.0) as
separate calls. Here the chain compiles to a single jitted program on the
sweep engine (spatial/sweep.py):

- normals come from the KNN-moments sweep (query-centered first and
  second neighbor moments, one windowed pass) + the vectorized Cardano
  eigensolver — no per-point KD-tree queries and no neighbor-index
  materialization at all;
- clustering is the sweep min-label propagation.

Per-query exactness flags from both sweeps surface in the output;
tests/test_aerial.py validates normal/cluster parity against the exact
per-op engine path.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.cloud import compaction_order
from ..ops.filters import voxel_downsample_masked, voxel_downsample_sweep_fused
from ..ops.normals import normals_from_moment_rows
from ..ops.segmentation import ransac_plane_masked
from ..spatial.sweep import (
    structure_from_sorted,
    sweep_cluster_labels,
    sweep_knn_moments_rows,
    sweep_moments_two_pass_rows,
)
from .kitti import check_backend


class AerialPipelineOutput(NamedTuple):
    centroids: jax.Array  # f32[N, 3] voxel centroids (padded)
    downsampled_valid: jax.Array  # bool[N]
    normals: jax.Array  # f32[N, 3] per-centroid PCA normals
    normals_ok: jax.Array  # bool[N] moments certified exact
    plane_normal: jax.Array  # f32[3]
    plane_d: jax.Array  # f32
    inlier_mask: jax.Array  # bool[N]
    obstacle_src: jax.Array  # i32[CAP]
    obstacle_valid: jax.Array  # bool[CAP]
    labels: jax.Array  # i32[CAP]
    obstacle_overflow: jax.Array  # bool
    cluster_exact: jax.Array  # bool
    ds_overflow: jax.Array  # bool


@partial(
    jax.jit,
    static_argnames=(
        "normals_k",
        "ransac_iters",
        "obstacle_cap",
        "cluster_wr",
        "backend",
        "ds_cap",
        "normals_rescue",
        "normals_fix_cap",
        "ransac_subsample",
        "normals_cell_factor",
    ),
)
def aerial_pipeline(
    xyz,
    valid,
    voxel_size,
    normals_cell,
    ransac_thresh,
    seed,
    cluster_r,
    viewpoint,
    *,
    normals_k: int = 15,
    ransac_iters: int = 300,
    obstacle_cap: int = 262_144,
    cluster_wr: int = 12,
    backend: str = "sweep",
    ds_cap: int | None = None,
    normals_rescue: bool = False,
    normals_fix_cap: int = 16384,
    ransac_subsample: int | None = None,
    normals_cell_factor: int | None = None,
):
    """Voxel -> sweep normals -> RANSAC -> ground removal -> sweep cluster.

    ``normals_cell`` is the KNN certification radius for the normals sweep
    (the k-th neighbor must provably lie within it; 3.0 m at the 241K
    scene's ~1 pt/m^2 downsampled density certifies ~93% of points — the
    rest are sparse-region points whose normals come from the candidates
    found: measured against the exact engine, the flagged rows' normals
    still match with median |dot| > 0.999 and >95% within |dot| > 0.99
    (tests/test_aerial.py::test_aerial_uncertified_normals_close_to_exact);
    a small residual of genuinely isolated points may differ).
    """
    check_backend(backend)

    # ── Step 1: voxel downsample ──
    # Voxel output is leading-compact; a static ds_cap trims the padded
    # tail every downstream stage would otherwise iterate (the 241K scene
    # yields ~208K centroids inside a 262144-row pad — ~20% dead rows).
    # Truncation, if the cap is ever exceeded, surfaces in ds_overflow
    # (bench.py checks it).
    if ds_cap is None:
        ds_cap = xyz.shape[0]
    ds_cap = min(ds_cap, xyz.shape[0])
    # Shared front end (see pipelines/kitti.py): when the normals
    # certification cell is a static integer number of voxels
    # (``normals_cell_factor``; the ``normals_cell`` argument is ignored
    # in that case), the compacted voxel rows are sorted ONCE into
    # cell-major sweep order and the moments sweep skips its own sort,
    # inverse permutation, and unsort gather. Centroid values stay
    # bitwise identical; row ORDER becomes cell-major (every consumer
    # below is order-agnostic, tests/test_aerial.py remaps by value).
    prebuilt = None
    if (
        normals_cell_factor is not None
        and not normals_rescue
        and ds_cap % 128 == 0
    ):
        fe = voxel_downsample_sweep_fused(
            xyz, valid, voxel_size, factor=normals_cell_factor,
            ds_cap=ds_cap,
        )
        centroids, ds_valid = fe["centroids"], fe["out_valid"]
        ds_overflow = fe["ds_overflow"]
        prebuilt = structure_from_sorted(
            centroids,
            ds_valid,
            fe["slin"],
            fe["extent"],
            fe["hi_cells"],
            fe["table_overflow"],
            wr=4,
        )
        normals_cell = voxel_size * float(normals_cell_factor)
    else:
        centroids_full, ds_valid_full = voxel_downsample_masked(
            xyz, valid, voxel_size
        )
        centroids = centroids_full[:ds_cap]
        ds_valid = ds_valid_full[:ds_cap]
        ds_overflow = jnp.any(ds_valid_full[ds_cap:])

    # ── Step 2: PCA normals from KNN moments — all in flat ROW layout
    # ([3, N]/[6, N]/1-D components): this stage runs entirely on 1-D
    # elementwise math until the single output stack. ──
    if normals_rescue:
        # A/B option: AABB-group-pruned exact rescue of the flagged rows
        # (sweep_moments_two_pass_rows) — raises normals certification from
        # ~93% toward ~100%. Default off: its cost on the card is not
        # measured yet.
        m1r, m2r, cnt, nok = sweep_moments_two_pass_rows(
            centroids,
            ds_valid,
            normals_cell,
            k=normals_k,
            fix_cap=normals_fix_cap,
        )
    else:
        m1r, m2r, cnt, nok = sweep_knn_moments_rows(
            centroids,
            ds_valid,
            normals_cell,
            k=normals_k,
            prebuilt=prebuilt,
        )
    normals = normals_from_moment_rows(m1r, m2r, cnt, centroids, viewpoint)

    # ── Step 3: RANSAC ground plane ──
    # Voxel output is leading-compact by construction, so RANSAC skips
    # its compaction sort (sample positions are row indices directly).
    pnormal, d, inlier_mask = ransac_plane_masked(
        centroids, ds_valid, ransac_thresh, seed, ransac_iters,
        assume_compact=True, score_subsample=ransac_subsample,
        # Reference-dispatch parity with the per-op API path (adaptive
        # early termination below 10K valid points / 16 iterations).
        adaptive=(ransac_subsample is None),
    )

    # ── Step 4+5: ground removal + clustering ──
    obstacle_mask = jnp.logical_and(ds_valid, jnp.logical_not(inlier_mask))
    order = compaction_order(obstacle_mask)
    obs_src = order[:obstacle_cap].astype(jnp.int32)
    obs_valid = jnp.take(obstacle_mask, obs_src)
    obs_xyz = jnp.take(centroids, obs_src, axis=0)
    n_obstacles = jnp.sum(obstacle_mask.astype(jnp.int32))
    overflow = n_obstacles > obstacle_cap

    # rep_labels=False: canonical component ids (extract_clusters groups
    # by value without interpreting it) — skips the 262K scatter-min.
    labels, cluster_exact = sweep_cluster_labels(
        obs_xyz, obs_valid, cluster_r, wr=cluster_wr, rep_labels=False,
    )

    return AerialPipelineOutput(
        centroids=centroids,
        downsampled_valid=ds_valid,
        normals=normals,
        normals_ok=nok,
        plane_normal=pnormal,
        plane_d=d,
        inlier_mask=inlier_mask,
        obstacle_src=obs_src,
        obstacle_valid=obs_valid,
        labels=labels,
        obstacle_overflow=overflow,
        cluster_exact=cluster_exact,
        ds_overflow=ds_overflow,
    )


def extract_clusters(out: AerialPipelineOutput, min_size: int, max_size: int):
    """Host-side cluster extraction, canonical ordering (size desc,
    lexicographic tiebreak) — same contract as pipelines.kitti."""
    import numpy as np

    labels = np.asarray(out.labels)
    obs_valid = np.asarray(out.obstacle_valid)
    valid_slots = np.nonzero(obs_valid)[0]
    lab = labels[valid_slots]
    order = np.argsort(lab, kind="stable")
    sl = lab[order]
    boundaries = np.nonzero(np.concatenate([[True], sl[1:] != sl[:-1]]))[0]
    clusters = []
    for i, b in enumerate(boundaries):
        e = boundaries[i + 1] if i + 1 < len(boundaries) else len(sl)
        members = valid_slots[order[b:e]]
        if min_size <= len(members) <= max_size:
            clusters.append(sorted(int(m) for m in members))
    clusters.sort(key=lambda c: (-len(c), c))
    return clusters
