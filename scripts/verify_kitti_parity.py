#!/usr/bin/env python3
"""Independent exactness check for fused KITTI frames.

bench.py and chip_smoke.py save the fused pipeline's fetched outputs (voxel
centroids, validity, the extracted clusters) to npz files and invoke this
script in a fresh CPU-only process (`pipelines.parity.run_kitti_verifier`).
Here the SOR stage is recomputed with an EXACT f64 scipy KD-tree oracle on
the same (bitwise-shared) centroids, then the downstream per-op path —
seeded RANSAC + euclidean clustering through the public API, exactly
`tests/test_pipeline.py:run_api_path`'s recipe (ref:
examples/python/kitti_obstacle_detection.py:87-122) — is replayed from that
exact keep-set, and the final cluster sets must be geometrically identical
to the fused run's. The fused SOR's uncertified rows are exactly the
isolated points both paths remove, so a frame's clusters carry an
exactness proof even when `sor_certified` is false.

Prints ONE JSON line per frame: {"cluster_parity_exact": bool, ...}.

Usage: python scripts/verify_kitti_parity.py <fused.npz> <seed> [...]
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# CPU only, and no persistent compilation cache: this process must never
# open the accelerator beside its parent, and reloading XLA:CPU
# executables from a cache can crash the process.
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

from scipy.spatial import cKDTree  # noqa: E402

import pointclouds_jax as pc  # noqa: E402
from pointclouds_jax.pipelines.parity import canon_clusters  # noqa: E402

# Defaults = bench.py's config; bench passes its ACTUAL parameters through
# the npz (key "params", a JSON string) so the two sides provably share one
# config — a drift shows up in the printed JSON instead of masquerading as
# a pipeline parity failure.
DEFAULT_PARAMS = dict(
    voxel=0.15, sor_k=20, sor_std=2.0, ransac_thresh=0.15, ransac_iters=500,
    cluster_r=0.8, min_size=10, max_size=20_000, ransac_subsample=4096,
)


def verify(path, seed):
    z = np.load(path)
    centroids = z["centroids"]
    ds_valid = z["ds_valid"].astype(bool)
    fused_points = z["cluster_points"]  # concatenated cluster member coords
    fused_offsets = z["cluster_offsets"]
    params = dict(DEFAULT_PARAMS)
    if "params" in z:
        params.update(json.loads(str(z["params"])))
    SOR_K = int(params["sor_k"])
    SOR_STD = float(params["sor_std"])
    RANSAC_THRESH = float(params["ransac_thresh"])
    RANSAC_ITERS = int(params["ransac_iters"])
    CLUSTER_R = float(params["cluster_r"])
    MIN_SIZE, MAX_SIZE = int(params["min_size"]), int(params["max_size"])
    VOXEL = np.float32(params["voxel"])

    pts = centroids[ds_valid]
    # Per-op path row order: compacted ascending canonical voxel key =
    # lexicographic cell coords (grid.cell_coords: floor(p/voxel) in f32).
    cc = np.floor(pts.astype(np.float32) / VOXEL).astype(np.int64)
    order = np.lexsort((cc[:, 2], cc[:, 1], cc[:, 0]))
    pts = np.ascontiguousarray(pts[order])

    # Exact SOR oracle: f64 KD-tree, k nearest non-self neighbors,
    # population-sigma threshold (ref: crates/filters/src/statistical_outlier.rs:43-66).
    tree = cKDTree(pts.astype(np.float64))
    d, _ = tree.query(pts.astype(np.float64), k=SOR_K + 1, workers=-1)
    means = d[:, 1:].mean(axis=1)
    mu = means.mean()
    sigma = np.sqrt(np.mean((means - mu) ** 2))
    keep = means <= mu + SOR_STD * sigma
    cleaned_pts = np.ascontiguousarray(pts[keep], dtype=np.float32)

    cleaned = pc.PointCloud.from_numpy(cleaned_pts)
    # Full scoring deliberately (no score_subsample even when bench used
    # the tournament): parity passing then proves the fused tournament
    # winner coincides with the exact full-scoring winner — the stronger
    # claim. The shared config above ensures every OTHER knob matches.
    plane = pc.ransac_plane_seeded(cleaned, RANSAC_THRESH, RANSAC_ITERS, seed)
    obstacles = cleaned.select_inverse(plane.inliers)
    clusters = pc.euclidean_cluster(obstacles, CLUSTER_R, MIN_SIZE, MAX_SIZE)

    obs_pts = obstacles.to_numpy()
    exact = canon_clusters([obs_pts[c] for c in clusters])
    fused = canon_clusters([
        fused_points[fused_offsets[i] : fused_offsets[i + 1]]
        for i in range(len(fused_offsets) - 1)
    ])
    exact_sizes = [len(c) for c in exact]
    fused_sizes = [len(c) for c in fused]
    ok = exact_sizes == fused_sizes and all(
        np.array_equal(a, f) for a, f in zip(exact, fused)
    )
    return {
        "cluster_parity_exact": bool(ok),
        "exact_sizes": exact_sizes,
        "fused_sizes": fused_sizes,
        "exact_cleaned": int(keep.sum()),
        "params": params,
    }


def main():
    args = sys.argv[1:]
    if not args or len(args) % 2:
        sys.exit("usage: verify_kitti_parity.py <fused.npz> <seed> [...]")
    for path, seed in zip(args[::2], args[1::2]):
        print(json.dumps(verify(path, int(seed))), flush=True)


if __name__ == "__main__":
    main()
