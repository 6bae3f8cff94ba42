#!/usr/bin/env python3
"""Aerial LiDAR processing demo: terrain/building/vegetation segmentation.

Reproduces the reference demo's workload and report format
(ref: examples/python/aerial_lidar.py:143-239): voxel 0.5 -> normals k=15 ->
RANSAC ground 0.3/300 -> remove ground -> cluster 2.0/20/100k.

Default path is the FUSED sweep pipeline (pipelines/aerial.py): the whole
chain compiles into one XLA program; per-frame time is measured
streaming-amortized over several frames like bench.py. --per-op runs the
reference-style per-call path through the public API instead.

Usage:
    python examples/aerial_lidar.py              # fused, full 241K-pt scene
    python examples/aerial_lidar.py --quick      # 0.1x scale
    python examples/aerial_lidar.py --per-op     # per-call API path
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

import pointclouds_jax as pc
from pointclouds_jax.core.cloud import make_cloud_arrays
from pointclouds_jax.pipelines.aerial import aerial_pipeline, extract_clusters
from pointclouds_jax.pipelines.scenes import aerial_scene
from pointclouds_jax.utils.profiling import device_line, gpu_card

# KNN certification radius for the normals sweep: ~3x the k=15 neighbor
# radius at the scene's ~1 pt/m^2 downsampled density.
NORMALS_CELL = 3.0


def run_fused(data, frames):
    arrs = make_cloud_arrays(data)
    vp = jnp.asarray([0.0, 0.0, 10000.0], jnp.float32)

    def run(seed):
        return aerial_pipeline(
            arrs.xyz,
            arrs.valid,
            np.float32(0.5),
            np.float32(NORMALS_CELL),
            np.float32(0.3),
            seed,
            np.float32(2.0),
            vp,
            # Shared voxel->sweep front end (6 x 0.5 m voxels = the
            # 3.0 m normals cell) — the bench.py operating point.
            normals_cell_factor=6,
        )

    jax.block_until_ready(run(0))  # compile
    t0 = time.perf_counter()
    for f in range(frames):
        out = run(f)
    jax.block_until_ready(out)
    frame_ms = (time.perf_counter() - t0) * 1e3 / frames

    clusters = extract_clusters(out, 20, 100_000)
    n_raw = int(np.asarray(arrs.valid).sum())
    nds = int(np.asarray(out.downsampled_valid).sum())
    print("=" * 60)
    print("Aerial LiDAR Pipeline (pointclouds_jax, fused sweep)")
    print("=" * 60)
    print(f"Raw points:             {n_raw}")
    print(f"Voxel downsample (0.5): {nds}")
    print(f"Normals (k=15):         {nds}  "
          f"[certified {int(np.asarray(out.normals_ok).sum())}]")
    print(f"Ground inliers:         {int(np.asarray(out.inlier_mask).sum())}")
    print(f"Clusters (r=2.0):       {len(clusters)}  "
          f"[exact={bool(out.cluster_exact)}]")
    for i, c in enumerate(clusters[:10]):
        print(f"  cluster {i}: {len(c)} points")
    print("-" * 60)
    print(f"Per-frame (streaming over {frames}): {frame_ms:.1f} ms -> "
          f"{n_raw / (frame_ms / 1e3) / 1e6:.2f} M pts/sec")
    return frame_ms


def run_per_op(data):
    cloud = pc.PointCloud.from_numpy(data)
    total0 = time.perf_counter()

    t0 = time.perf_counter()
    ds = pc.voxel_downsample(cloud, 0.5)
    t_voxel = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    with_normals = pc.estimate_normals(ds, 15)
    t_normals = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    plane = pc.ransac_plane(with_normals, 0.3, 300)
    t_ransac = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    objects = with_normals.select_inverse(plane.inliers)
    clusters = pc.euclidean_cluster(objects, 2.0, 20, 100_000)
    t_cluster = (time.perf_counter() - t0) * 1e3

    total_ms = (time.perf_counter() - total0) * 1e3

    print("=" * 60)
    print("Aerial LiDAR Pipeline (pointclouds_jax, per-op API)")
    print("=" * 60)
    print(f"Raw points:             {cloud.len()}")
    print(f"Voxel downsample (0.5): {ds.len()}  [{t_voxel:.1f} ms]")
    print(f"Normals (k=15):         {with_normals.len()}  [{t_normals:.1f} ms]")
    print(f"Ground inliers:         {len(plane.inliers)}  [{t_ransac:.1f} ms]")
    print(f"Object points:          {objects.len()}")
    print(f"Clusters (r=2.0):       {len(clusters)}  [{t_cluster:.1f} ms]")
    for i, c in enumerate(clusters[:10]):
        print(f"  cluster {i}: {len(c)} points")
    print("-" * 60)
    print(f"Total: {total_ms:.1f} ms -> "
          f"{cloud.len() / (total_ms / 1e3) / 1e6:.2f} M pts/sec")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--per-op", action="store_true")
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()

    scale = 0.1 if args.quick else 1.0
    data = aerial_scene(seed=42, scale=scale)
    print(f"Device: {device_line()} {gpu_card()}".rstrip())
    print(f"Aerial scene: {len(data)} points over 500x500 m")

    if args.per_op:
        run_per_op(data)
    else:
        run_fused(data, args.frames)


if __name__ == "__main__":
    main()
