#!/usr/bin/env python3
"""Quickstart: the 60-second tour of pointclouds_jax.

The reference ships a near-empty placeholder here
(ref: examples/python/quickstart.py:1-4); this version actually walks the
API surface end to end on a tiny synthetic cloud.

Run on CPU or GPU (the package picks whatever JAX platform is active):

    python examples/quickstart.py
"""

import numpy as np

import pointclouds_jax as pc  # or: import pointclouds_rs as pc (drop-in shim)


def main():
    rng = np.random.default_rng(0)
    points = rng.standard_normal((1000, 3)).astype(np.float32)

    cloud = pc.PointCloud.from_numpy(points)
    print(f"cloud: {cloud!r}")

    # Filters
    down = pc.voxel_downsample(cloud, voxel_size=0.5)
    print(f"voxel 0.5       -> {down.len()} points")
    band = pc.passthrough_filter(cloud, "z", -1.0, 1.0)
    print(f"passthrough z   -> {band.len()} points")
    clean = pc.statistical_outlier_removal(cloud, k=8, std_mul=1.0)
    print(f"SOR k=8 s=1.0   -> {clean.len()} points")

    # Normals (returned as a new cloud with normals attached; they survive
    # a PLY round-trip)
    with_normals = pc.estimate_normals(clean, k=10)
    print(f"normals         -> cloud of {with_normals.len()} points")

    # Spatial queries
    dists, idx = pc.knn(cloud, points[:4], k=5)
    print(f"knn(4 queries)  -> dists {np.asarray(dists).shape}")
    hits = pc.radius_search(cloud, points[0], radius=0.75)
    print(f"radius_search   -> {len(hits)} neighbors")

    # Segmentation
    plane = pc.ransac_plane_seeded(
        cloud, distance_threshold=0.25, iterations=100, seed=7
    )
    print(f"ransac plane    -> n={plane.normal}, {len(plane.inliers)} inliers")
    clusters = pc.euclidean_cluster(cloud, 0.4, 5, 10**9)
    print(f"clusters        -> {len(clusters)} of sizes {[len(c) for c in clusters][:5]}")

    # Registration
    shifted = pc.apply_transform(cloud, np.eye(3), [0.05, 0.0, 0.0])
    icp = pc.icp_point_to_point(cloud, shifted, max_iterations=20)
    print(
        f"icp             -> converged={icp.converged} "
        f"t={[round(t, 4) for t in icp.translation]}"
    )


if __name__ == "__main__":
    main()
