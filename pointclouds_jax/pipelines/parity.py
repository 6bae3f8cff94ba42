"""Geometric cluster comparison and the f64 KITTI parity verifier launcher.

Two pipelines that compute the same clusters may number their rows
differently (the fused pipeline's sweep order vs the per-op API's compacted
order), so clusters are compared as point SETS: each cluster's member
coordinates in lexicographic row order, clusters ordered by (-size,
smallest member point).
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
VERIFIER = REPO / "scripts" / "verify_kitti_parity.py"


def lexsorted_rows(a):
    """Rows in lexicographic order — column-independent np.sort(axis=0)
    would compare two DIFFERENT point sets equal (e.g. {(0,1),(1,0)} vs
    {(0,0),(1,1)})."""
    return a[np.lexsort(a.T[::-1])]


def canon_clusters(pts_list, decimals: int | None = None):
    """Clusters as row-lexsorted arrays, ordered by (-size, smallest member
    point): equal-size clusters pair by geometry, not by list position
    (which depends on path-specific row numbering). Coordinates stay f32
    (bitwise comparison) unless ``decimals`` rounds them in f64."""
    out = []
    for p in pts_list:
        p = np.asarray(p, np.float32).reshape(-1, 3)
        if decimals is not None:
            p = np.round(p.astype(np.float64), decimals)
        out.append(lexsorted_rows(p))
    out.sort(
        key=lambda p: (-len(p), tuple(p[0].tolist()) if len(p) else ())
    )
    return out


def clusters_equal(a_pts, b_pts, decimals: int | None = None) -> bool:
    """True iff two lists of cluster point arrays are the same point sets:
    bitwise-equal coordinates, or equal after rounding to ``decimals``
    (for paths whose centroid sums reassociate by an ULP)."""
    a = canon_clusters(a_pts, decimals)
    b = canon_clusters(b_pts, decimals)
    return [len(c) for c in a] == [len(c) for c in b] and all(
        np.array_equal(x, y) for x, y in zip(a, b)
    )


def fused_cluster_points(out, clusters):
    """Member coordinates of each extracted fused-pipeline cluster
    (`pipelines.kitti.extract_clusters` slot indices -> obstacle points)."""
    centroids = np.asarray(out.centroids)
    obs = centroids[np.asarray(out.obstacle_src)]
    valid_slots = np.nonzero(np.asarray(out.obstacle_valid))[0]
    return [obs[valid_slots[c]] for c in clusters]


def run_kitti_verifier(frames, params, timeout: float = 900.0):
    """Replay each fused KITTI frame through the f64 oracle in a CPU child
    process (scripts/verify_kitti_parity.py).

    ``frames``: list of (pipeline output, extracted clusters, RANSAC seed).
    Returns one result dict per frame; on any failure every frame gets
    {"cluster_parity_exact": False, "error": ...}.

    The child runs with JAX_PLATFORMS=cpu in its environment, so it never
    opens the accelerator beside the parent, and it turns the persistent
    compilation cache off itself (XLA:CPU executables must never land in
    the accelerator's cache)."""
    try:
        with tempfile.TemporaryDirectory() as tmp:
            argv = [sys.executable, str(VERIFIER)]
            for i, (out, clusters, seed) in enumerate(frames):
                pts = fused_cluster_points(out, clusters)
                path = os.path.join(tmp, f"frame{i}.npz")
                np.savez(
                    path,
                    centroids=np.asarray(out.centroids),
                    ds_valid=np.asarray(out.downsampled_valid),
                    cluster_points=(
                        np.concatenate(pts)
                        if pts
                        else np.zeros((0, 3), np.float32)
                    ),
                    cluster_offsets=np.cumsum(
                        [0] + [len(p) for p in pts]
                    ).astype(np.int64),
                    params=json.dumps(params),
                )
                argv += [path, str(int(seed))]
            env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
            res = subprocess.run(
                argv, capture_output=True, text=True, timeout=timeout,
                cwd=str(REPO), env=env,
            )
            lines = [
                ln for ln in res.stdout.splitlines() if ln.startswith("{")
            ]
            if res.returncode != 0 or len(lines) != len(frames):
                raise RuntimeError(
                    f"verifier rc={res.returncode}: {res.stderr[-400:]}"
                )
            return [json.loads(ln) for ln in lines]
    except Exception as e:  # the caller's gate reads cluster_parity_exact
        return [
            {"cluster_parity_exact": False, "error": str(e)[:400]}
            for _ in frames
        ]
