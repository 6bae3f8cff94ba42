#!/usr/bin/env python3
"""Microbenchmark suite: per-op timings at reference-comparable sizes.

The analogue of the reference's five Criterion suites
(ref: benches/bench_{voxel,kdtree,normals,icp,filters}.rs), with the same
workload sizes so numbers line up against BENCHMARKS.md. Timing excludes
compilation (warmup call first) and ends each call in
`jax.block_until_ready`; the public API ops return host values, so their
time includes the device-to-host fetch a caller pays. Prints the device
and the card's name and power limit first.

Usage: python benches/bench_ops.py [--sizes small]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax

import pointclouds_jax as pc
from pointclouds_jax.spatial import engine
from pointclouds_jax.utils.profiling import device_line, gpu_card


def timeit(name, fn, *args, reps=5, ref_ms=None):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    wall = min(ts)
    ref = f"  ref={ref_ms:.2f}ms ({ref_ms / wall:.1f}x)" if ref_ms else ""
    print(f"{name:42s} wall={wall:8.2f}ms{ref}")
    return out


def single_query_bench(c, label, ref_knn_us, ref_rad_us, n_queries=20000,
                       box=100.0):
    """Per-query cost of the build-once host index, on the REFERENCE'S OWN
    Criterion methodology (benches/bench_kdtree.rs): points uniform in a
    0..100 box, ONE fixed query at the box center repeated (warm cache),
    k=10 KNN and radius-0.1 search (~zero hits at these densities). A
    harder secondary row times 2000 DISTINCT random queries (cold cache,
    real hit counts) — the reference has no equivalent row."""
    t0 = time.perf_counter()
    idx = c._index()
    build_ms = (time.perf_counter() - t0) * 1e3

    q = np.full((3,), box / 2.0, np.float64)
    for _ in range(100):
        idx.knn(q, 10)  # warm
    t0 = time.perf_counter()
    for _ in range(n_queries):
        idx.knn(q, 10)
    knn_us = (time.perf_counter() - t0) * 1e6 / n_queries

    for _ in range(100):
        idx.radius(q, 0.1)
    t0 = time.perf_counter()
    for _ in range(n_queries):
        idx.radius(q, 0.1)
    rad_us = (time.perf_counter() - t0) * 1e6 / n_queries

    native = getattr(idx, "_native", None) is not None
    print(
        f"{f'host index {label} (ref methodology)':42s} "
        f"build={build_ms:7.2f}ms  "
        f"knn k=10={knn_us:6.2f}us/q (ref={ref_knn_us}us)  "
        f"radius(0.1)={rad_us:6.3f}us/q (ref={ref_rad_us}us)  "
        f"native={native}"
    )

    rng = np.random.default_rng(9)
    qs = (rng.random((2000, 3)) * box).astype(np.float64)
    t0 = time.perf_counter()
    for qq in qs:
        idx.knn(qq, 10)
    knn2 = (time.perf_counter() - t0) * 1e6 / len(qs)
    t0 = time.perf_counter()
    for qq in qs:
        idx.radius(qq, 2.0)
    rad2 = (time.perf_counter() - t0) * 1e6 / len(qs)
    print(
        f"{f'host index {label} (2000 random queries)':42s} "
        f"{'':15s}  knn k=10={knn2:6.2f}us/q  "
        f"radius(2.0)={rad2:6.2f}us/q  (no ref row)"
    )


def cloud(n, seed=0, box=10.0):
    rng = np.random.default_rng(seed)
    return pc.PointCloud.from_numpy(
        (rng.random((n, 3)) * box).astype(np.float32)
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="full", choices=("small", "full"))
    args = ap.parse_args()
    full = args.sizes == "full"

    print(f"device: {device_line()} {gpu_card()}".rstrip())

    # Reference numbers from BASELINE.md (M4 Max CPU, Criterion medians)
    c10k = cloud(10_000)
    c100k = cloud(100_000)
    c1m = cloud(1_000_000) if full else None

    timeit("voxel_downsample 10K", pc.voxel_downsample, c10k, 0.5, ref_ms=0.061)
    timeit("voxel_downsample 100K", pc.voxel_downsample, c100k, 0.5, ref_ms=0.703)
    if full:
        timeit("voxel_downsample 1M", pc.voxel_downsample, c1m, 0.5, ref_ms=8.3)

    timeit("passthrough 100K", pc.passthrough_filter, c100k, "x", 2.0, 8.0, ref_ms=0.372)
    if full:
        timeit("passthrough 1M", pc.passthrough_filter, c1m, "x", 2.0, 8.0, ref_ms=5.5)

    # Batched KNN vs the reference's per-query KD-tree numbers: the
    # reference does 1.47 us/query at 100K -> 147 ms for all-points KNN.
    arrs = c100k._arrs

    def knn_all(xyz, valid):
        return engine.knn(xyz, valid, xyz, valid, 10)

    timeit("knn k=10 all 100K pts", knn_all, arrs.xyz, arrs.valid, ref_ms=147.0)

    # Single-query path: the build-once native host index serves the
    # reference's per-query KD-tree rows (BENCHMARKS.md:43-48 — 1.47 us
    # KNN k=10, 235 ns radius at 100K; 2.13 us / 419 ns at 1M). Host-side
    # timing. Same box/query/radius as the
    # reference's benches/bench_kdtree.rs.
    single_query_bench(cloud(100_000, box=100.0), "100K", 1.47, 0.235)
    if full:
        single_query_bench(cloud(1_000_000, box=100.0), "1M", 2.13, 0.419)

    timeit("SOR k=10 10K", pc.statistical_outlier_removal, c10k, 10, 2.0, ref_ms=11.2)
    timeit("SOR k=10 100K", pc.statistical_outlier_removal, c100k, 10, 2.0, ref_ms=128.0)

    timeit("radius_outlier 10K", pc.radius_outlier_removal, c10k, 0.5, 5, ref_ms=1.35)
    timeit("radius_outlier 100K", pc.radius_outlier_removal, c100k, 0.5, 5, ref_ms=19.1)

    timeit("estimate_normals k=10 10K", pc.estimate_normals, c10k, 10, ref_ms=1.4)
    timeit("estimate_normals k=10 100K", pc.estimate_normals, c100k, 10, ref_ms=15.8)

    src = cloud(10_000, seed=1)
    tgt = pc.PointCloud.from_numpy(src.to_numpy() + np.float32(0.05))
    timeit(
        "icp_point_to_point 10K x50",
        lambda s, t: pc.icp_point_to_point(s, t, max_iterations=50),
        src, tgt, ref_ms=5.15,
    )

    rng = np.random.default_rng(3)
    seg = np.vstack([
        (rng.random((80_000, 3)) * [20, 20, 0.05]).astype(np.float32),
        (rng.random((20_000, 3)) * 20).astype(np.float32),
    ])
    cseg = pc.PointCloud.from_numpy(seg)
    timeit(
        "ransac_plane 100K x500",
        lambda c: pc.ransac_plane_seeded(c, 0.05, 500, 7),
        cseg, ref_ms=2.1,
    )
    # Stress row: percolating slab (per-point degree ~150) — much denser
    # than any reference workload, no baseline row to compare against.
    timeit(
        "euclidean_cluster 100K slab r=0.5 (stress)",
        lambda c: pc.euclidean_cluster(c, 0.5, 10, 10**9),
        cseg,
    )

    # The reference's own 16 ms cluster number is its aerial workload:
    # 161K non-ground points at r=2.0 after downsample+RANSAC
    # (BENCHMARKS.md:85-92, examples/python/aerial_lidar.py:181). Mirror
    # that workload exactly.
    from pointclouds_jax.pipelines.scenes import aerial_scene

    ds = pc.voxel_downsample(
        pc.PointCloud.from_numpy(aerial_scene(seed=7)), 0.5
    )
    ground = pc.ransac_plane_seeded(ds, 0.3, 300, 11)
    non_ground = ds.select_inverse(ground.inliers)
    timeit(
        f"euclidean_cluster aerial {non_ground.len()//1000}K r=2.0",
        lambda c: pc.euclidean_cluster(c, 2.0, 20, 100_000),
        non_ground, ref_ms=16.0,
    )


if __name__ == "__main__":
    main()
