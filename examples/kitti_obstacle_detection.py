#!/usr/bin/env python3
"""KITTI-style obstacle detection via the fused pipeline.

Reproduces the reference demo's workload and report format
(ref: examples/python/kitti_obstacle_detection.py) but runs the whole
5-step chain as one jitted XLA program per frame.

Usage:
    python examples/kitti_obstacle_detection.py              # synthetic scene
    python examples/kitti_obstacle_detection.py scene.pcd    # from file
    python examples/kitti_obstacle_detection.py --frames 20  # p50 over frames
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")  # repo-root execution

import jax

from pointclouds_jax.core.cloud import make_cloud_arrays
from pointclouds_jax.pipelines.kitti import (
    extract_clusters,
    kitti_obstacle_pipeline,
)
from pointclouds_jax.pipelines.scenes import kitti_scene
from pointclouds_jax.utils.profiling import device_line, gpu_card

VOXEL = 0.15
SOR_K, SOR_STD = 20, 2.0
RANSAC_T, RANSAC_ITERS = 0.15, 500
CLUSTER_R, MIN_SIZE, MAX_SIZE = 0.8, 10, 20_000


def run_frame(arrs, seed):
    out = kitti_obstacle_pipeline(
        arrs.xyz,
        arrs.valid,
        np.float32(VOXEL),
        np.float32(SOR_STD),
        np.float32(RANSAC_T),
        seed,
        np.float32(CLUSTER_R),
        sor_k=SOR_K,
        ransac_iters=RANSAC_ITERS,
    )
    return jax.block_until_ready(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default=None)
    ap.add_argument("--frames", type=int, default=1)
    args = ap.parse_args()

    if args.scene:
        import pointclouds_jax as pc

        data = pc.read_pcd(args.scene).to_numpy()
    else:
        data = kitti_scene(seed=42)

    arrs = make_cloud_arrays(data)
    print(f"Device: {device_line()} {gpu_card()}".rstrip())
    print(f"Input: {len(data)} points (padded to {arrs.capacity})")

    # Warmup / compile
    t0 = time.perf_counter()
    out = run_frame(arrs, 42)
    print(f"Compile+first frame: {(time.perf_counter() - t0) * 1e3:.1f} ms")

    times = []
    for f in range(args.frames):
        t0 = time.perf_counter()
        out = run_frame(arrs, 42 + f)
        times.append((time.perf_counter() - t0) * 1e3)

    clusters = extract_clusters(out, MIN_SIZE, MAX_SIZE)
    n_ds = int(np.asarray(out.downsampled_valid).sum())
    n_clean = int(np.asarray(out.cleaned_valid).sum())
    n_inl = int(np.asarray(out.inlier_mask).sum())

    print("=" * 60)
    print("KITTI Obstacle Detection Pipeline (pointclouds_jax)")
    print("=" * 60)
    print(f"Raw points:            {len(data)}")
    print(f"After downsample:      {n_ds}")
    print(f"After outlier removal: {n_clean}")
    print(f"Ground plane inliers:  {n_inl}")
    print(f"Plane normal:          {np.asarray(out.plane_normal).round(4).tolist()}")
    print(f"Obstacle points:       {n_clean - n_inl}")
    print(f"Clusters found:        {len(clusters)}")
    for i, c in enumerate(clusters[:10]):
        print(f"  cluster {i}: {len(c)} points")
    p50 = float(np.percentile(times, 50))
    print("-" * 60)
    print(f"Frames: {len(times)}  p50: {p50:.2f} ms  "
          f"min: {min(times):.2f} ms  max: {max(times):.2f} ms")
    print(f"Throughput: {len(data) / (p50 / 1e3) / 1e6:.2f} M pts/sec")


if __name__ == "__main__":
    main()
