#!/usr/bin/env python3
"""Head-to-head benchmark vs Open3D (when installed).

Mirrors the reference's comparison harness
(ref: tests/bench_vs_open3d.py:94-164): median-of-10 timings for voxel
downsample, passthrough, normal estimation, and RANSAC at 100K and 1M
points, with the same ">=3x target" report line.

Open3D is not installable in every environment (it is absent from this
one, and the reference notes it publishes no recorded Open3D data either
— ref: BENCHMARKS.md:152). Without open3d this script still times our
side and falls back to comparing against the reference library's own
recorded medians (BASELINE.md, M4 Max CPU), clearly labeled as such.
"""

import time

import numpy as np

import pointclouds_jax as pc

try:
    import open3d as o3d  # type: ignore

    HAVE_O3D = True
except ImportError:
    o3d = None
    HAVE_O3D = False

# The reference library's own Criterion medians (BASELINE.md, M4 Max CPU)
# — the fallback comparison column when open3d is not installed. These are
# pointclouds-rs numbers, NOT Open3D numbers (none are published).
REFERENCE_MS = {
    ("voxel", 100_000): 0.703,
    ("voxel", 1_000_000): 8.3,
    ("passthrough", 100_000): 0.372,
    ("passthrough", 1_000_000): 5.5,
    ("normals", 100_000): 15.8,
    ("ransac", 100_000): 2.1,
}


def median_ms(fn, reps=10):
    fn()  # warmup (compile)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def o3d_cloud(points):
    geo = o3d.geometry.PointCloud()
    geo.points = o3d.utility.Vector3dVector(points.astype(np.float64))
    return geo


def main():
    rng = np.random.default_rng(42)
    rows = []
    for n in (100_000, 1_000_000):
        pts = (rng.random((n, 3)) * 20.0).astype(np.float32)
        cloud = pc.PointCloud.from_numpy(pts)

        rows.append(
            ("voxel", n, pts,
             median_ms(lambda: pc.voxel_downsample(cloud, 0.5).len()))
        )
        rows.append(
            ("passthrough", n, pts,
             median_ms(
                 lambda: pc.passthrough_filter(cloud, "x", 5.0, 15.0).len()
             ))
        )
        if n == 100_000:
            rows.append(
                ("normals", n, pts,
                 median_ms(lambda: pc.estimate_normals(cloud, 10).len()))
            )
            rows.append(
                ("ransac", n, pts,
                 median_ms(lambda: pc.ransac_plane_seeded(cloud, 0.05, 100, 7)))
            )

    other_name = "open3d" if HAVE_O3D else "pcrs-ref"
    print(
        f"{'op':14s} {'points':>10s} {'ours (ms)':>10s} "
        f"{other_name + ' (ms)':>14s} {'speedup':>8s}"
    )
    passing = []
    for op, n, pts, ours in rows:
        if HAVE_O3D:
            geo = o3d_cloud(pts)
            if op == "voxel":
                other = median_ms(lambda: geo.voxel_down_sample(0.5))
            elif op == "passthrough":
                bb = o3d.geometry.AxisAlignedBoundingBox(
                    (5.0, -1e9, -1e9), (15.0, 1e9, 1e9)
                )
                other = median_ms(lambda: geo.crop(bb))
            elif op == "normals":
                other = median_ms(
                    lambda: geo.estimate_normals(
                        o3d.geometry.KDTreeSearchParamKNN(10)
                    )
                )
            else:
                other = median_ms(lambda: geo.segment_plane(0.05, 3, 100))
        else:
            other = REFERENCE_MS.get((op, n))
        if other is None:
            continue
        ratio = other / max(ours, 1e-9)
        passing.append(ratio >= 3.0)
        print(f"{op:14s} {n:>10d} {ours:>10.2f} {other:>14.2f} {ratio:>7.1f}x")
    verdict = "PASS" if passing and all(passing) else "MIXED — see individual results"
    print(f"\n  Target (>=3x): {verdict}")
    if not HAVE_O3D:
        print(
            "  (open3d not installed: comparison column is the reference "
            "library's recorded CPU medians, not Open3D.)"
        )


if __name__ == "__main__":
    main()
