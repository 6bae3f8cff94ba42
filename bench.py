#!/usr/bin/env python3
"""Benchmark: the fused KITTI (122K points) and aerial (241K points)
pipelines on one GPU.

Prints the device (platform, kind, count) and the card's name and power
limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "...", "vs_baseline": N, ...}

Baseline: the reference's 89.5 ms p50 per 122K-pt frame on an Apple M4 Max
CPU (ref: README.md:23-25, mirrored in BASELINE.md; p50 over 100 frames).
The headline value is the streaming per-frame time (frames dispatched
back-to-back, one sync at the end); `sequential_p50_ms` is the
reference-methodology p50 over 100 individually synced frames.
vs_baseline > 1 means this framework is faster.

The workload is full capacity (no ds truncation; ~93K centroids from the
122K-pt scene), and the JSON attributes the run: whether any capacity
overflowed, whether every SOR decision was certified exact, and whether
the measured frame's clusters match the f64 oracle replay
(scripts/verify_kitti_parity.py, run in a CPU-only child process).

The configuration below is shared with chip_smoke.py.

Usage: python bench.py   (exits non-zero without a GPU)
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pointclouds_jax.core.cloud import make_cloud_arrays  # noqa: E402
from pointclouds_jax.pipelines.aerial import aerial_pipeline  # noqa: E402
from pointclouds_jax.pipelines.kitti import (  # noqa: E402
    extract_clusters,
    kitti_obstacle_pipeline,
)
from pointclouds_jax.pipelines.parity import run_kitti_verifier  # noqa: E402
from pointclouds_jax.pipelines.scenes import (  # noqa: E402
    aerial_scene,
    velodyne_scene,
)
from pointclouds_jax.utils.profiling import (  # noqa: E402
    device_line,
    gpu_card,
    require_gpu,
)

BASELINE_P50_MS = 89.5
AERIAL_BASELINE_MS = 87.0  # ref BENCHMARKS.md:123-132 (241K pts, M4 Max CPU)
N_POINTS = 122_000
FRAMES = 100
AERIAL_FRAMES = 30

# THE measured KITTI configuration — shared verbatim with the parity
# verifier (scripts/verify_kitti_parity.py) via the npz so both sides
# provably use one config.
KITTI_PARAMS = dict(
    voxel=0.15, sor_k=20, sor_std=2.0, ransac_thresh=0.15, ransac_iters=500,
    cluster_r=0.8, min_size=10, max_size=20_000, ransac_subsample=4096,
)
KITTI_KWARGS = dict(
    sor_k=KITTI_PARAMS["sor_k"],
    ransac_iters=KITTI_PARAMS["ransac_iters"],
    # 93,033 centroids fit a 98,304-row cap with 5.6% headroom; truncation
    # would surface in grid_flags[4].
    ds_cap=98_304,
    # Tournament scoring (subsample + top-8 full-cloud rescore); the final
    # inliers stay full-cloud.
    ransac_subsample=KITTI_PARAMS["ransac_subsample"],
    # ~6.2K obstacles across the 100 seeds: 8192 slots keep 30% headroom
    # (obstacle_overflow reports a shortfall).
    obstacle_cap=8192,
)

AERIAL_PARAMS = dict(
    voxel=0.5, normals_cell=3.0, ransac_thresh=0.3, cluster_r=2.0,
)
AERIAL_VIEWPOINT = (0.0, 0.0, 10000.0)
AERIAL_KWARGS = dict(
    # ~208K centroids / ~162K obstacles on this scene: caps leave 10-20%
    # headroom and the overflow flags stay honest.
    ds_cap=229_376,
    obstacle_cap=196_608,
    ransac_subsample=4096,
    # Shared voxel->sweep front end (normals cell = 6 x 0.5 m voxels = the
    # demo's 3.0 m): the moments sweep reuses the voxel stage's sort.
    normals_cell_factor=6,
)


def kitti_args(arrs, seed):
    p = KITTI_PARAMS
    return (
        arrs.xyz, arrs.valid, np.float32(p["voxel"]), np.float32(p["sor_std"]),
        np.float32(p["ransac_thresh"]), np.int32(seed),
        np.float32(p["cluster_r"]),
    )


def aerial_args(arrs, seed):
    p = AERIAL_PARAMS
    return (
        arrs.xyz, arrs.valid, np.float32(p["voxel"]),
        np.float32(p["normals_cell"]), np.float32(p["ransac_thresh"]),
        np.int32(seed), np.float32(p["cluster_r"]),
        jnp.asarray(AERIAL_VIEWPOINT, jnp.float32),
    )


def compile_kitti(arrs):
    """AOT-compiled KITTI pipeline: frames dispatch the compiled
    executable, so the jit dispatch path's host cost is not charged to
    every frame (production serving does the same)."""
    return kitti_obstacle_pipeline.lower(
        *kitti_args(arrs, 0), **KITTI_KWARGS
    ).compile()


def compile_aerial(arrs):
    return aerial_pipeline.lower(
        *aerial_args(arrs, 0), **AERIAL_KWARGS
    ).compile()


def main():
    require_gpu()
    card = gpu_card()
    print(device_line(), flush=True)
    print(card, flush=True)

    arrs = make_cloud_arrays(velodyne_scene(seed=0, n_points=N_POINTS))
    compiled = compile_kitti(arrs)

    def run(seed):
        return compiled(*kitti_args(arrs, seed))

    jax.block_until_ready(run(0))
    jax.block_until_ready(run(1))

    times = []
    frame_flags = []  # device refs, fetched after timing: an overflow on
    # ANY frame must surface, not just the final seed's
    for f in range(FRAMES):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(f))
        times.append((time.perf_counter() - t0) * 1e3)
        frame_flags.append(
            (out.grid_flags, out.obstacle_overflow, out.sor_certified)
        )
    p50 = float(np.percentile(times, 50))
    any_grid = bool(np.any([np.asarray(g)[:4] for g, _, _ in frame_flags]))
    any_ds_trunc = bool(np.any([np.asarray(g)[4] for g, _, _ in frame_flags]))
    any_obs_ovf = bool(np.any([np.asarray(o) for _, o, _ in frame_flags]))
    all_sor_cert = bool(np.all([np.asarray(s) for _, _, s in frame_flags]))
    del frame_flags

    # Streaming throughput: frames dispatched back-to-back, one sync.
    t0 = time.perf_counter()
    for f in range(FRAMES):
        out_s = run(f)
    jax.block_until_ready(out_s)
    stream_ms = (time.perf_counter() - t0) * 1e3 / FRAMES

    # Sanity: the pipeline must actually find the scene's obstacle clusters.
    clusters = extract_clusters(
        out, KITTI_PARAMS["min_size"], KITTI_PARAMS["max_size"]
    )
    assert len(clusters) >= 3, f"expected >=3 clusters, got {len(clusters)}"

    # Fused-vs-exact cluster parity of the measured frame: a CPU child
    # recomputes SOR with an exact f64 scipy KD-tree on the same centroids,
    # replays the per-op RANSAC+cluster path, and checks geometric cluster
    # equality. The fused SOR's uncertified rows are isolated points
    # removed by both paths, so this certifies the headline metric even
    # when pass-1's per-query certificate (`sor_certified`) is false.
    (parity,) = run_kitti_verifier(
        [(out, clusters, FRAMES - 1)], KITTI_PARAMS
    )

    # Aerial end-to-end (241K pts; ref 87 ms total on M4 Max CPU).
    aarrs = make_cloud_arrays(aerial_scene(seed=42, scale=1.0))
    acompiled = compile_aerial(aarrs)

    def arun(seed):
        return acompiled(*aerial_args(aarrs, seed))

    jax.block_until_ready(arun(0))
    aflags = []
    t0 = time.perf_counter()
    for f in range(AERIAL_FRAMES):
        aout = arun(f)
        aflags.append((aout.ds_overflow, aout.obstacle_overflow,
                       aout.cluster_exact))
    jax.block_until_ready(aout)
    aerial_ms = (time.perf_counter() - t0) * 1e3 / AERIAL_FRAMES
    a_ds_trunc = bool(np.any([np.asarray(v) for v, _, _ in aflags]))
    a_obs_ovf = bool(np.any([np.asarray(v) for _, v, _ in aflags]))
    a_clu_exact = bool(np.all([np.asarray(v) for _, _, v in aflags]))

    devs = jax.devices()
    print(
        json.dumps(
            {
                "metric": "kitti_pipeline_frame_time_122k_streaming",
                "value": stream_ms,
                "unit": "ms",
                "vs_baseline": BASELINE_P50_MS / stream_ms,
                "sequential_p50_ms": p50,
                "frames": FRAMES,
                "ds_points": int(np.asarray(out.downsampled_valid).sum()),
                # OR/AND-accumulated over ALL seeds, not just the final
                # frame's sample.
                "ds_truncated": any_ds_trunc,
                "any_grid_overflow": any_grid,
                "obstacle_overflow": any_obs_ovf,
                "sor_certified": all_sor_cert,
                "cluster_parity_exact": bool(
                    parity.get("cluster_parity_exact", False)
                ),
                "clusters": [len(c) for c in clusters],
                "aerial_frame_ms_241k": aerial_ms,
                "aerial_vs_baseline": AERIAL_BASELINE_MS / aerial_ms,
                "aerial_ds_points": int(
                    np.asarray(aout.downsampled_valid).sum()
                ),
                "aerial_ds_truncated": a_ds_trunc,
                "aerial_obstacle_overflow": a_obs_ovf,
                "aerial_cluster_exact": a_clu_exact,
                "device": {
                    "platform": devs[0].platform,
                    "kind": devs[0].device_kind,
                    "count": len(devs),
                    "card": card,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
