#!/usr/bin/env python3
"""Smoke test of the main paths on the GPU, at full size, in one process.

    python chip_smoke.py               # one GPU, phases 0-4
    python chip_smoke.py --four-cards  # four GPUs: the multi-device paths

Phases (one GPU):
  0. device: JAX must report a GPU; prints the device and the card's name
     and power limit (nvidia-smi).
  1. fused KITTI pipeline, 122K-point Velodyne frame, bench.py's
     configuration: compile seconds, memory analysis, 5 timed frames,
     peak device memory; every frame SOR-certified, no overflow, >= 3
     clusters, and clusters equal to the f64 oracle replay
     (scripts/verify_kitti_parity.py in a CPU-only child process).
  2. fused aerial pipeline, 241K points: same lines; clustering exact and
     no overflow on every frame; certified KNN moments and normals against
     an f64 brute-force reference on a sample of rows.
  3. the per-op API through the `pointclouds_rs` shim on the phase-1 frame
     (voxel -> SOR -> RANSAC -> select inverse -> cluster): clusters equal
     phase 1's; point-to-plane ICP recovers a known rigid transform.
  4. stage timings: each hot stage as its own jitted call at the phase-1
     and phase-2 shapes (a finding, not a metric).

--four-cards runs only the multi-device KITTI paths (tiled shard_map on a
frames:2 x points:2 mesh, GSPMD-sharded on frames:4) on four full frames
and compares each frame's clusters with the one-card pipeline on card 0.

Every line carries the card's name and power limit. Any failure exits
non-zero; only a run in which every check passed prints the last line
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

KITTI_FRAMES = 5
AERIAL_FRAMES = 5
STAGE_REPS = 10
MOMENT_SAMPLE_ROWS = 256
EPS32 = float(np.finfo(np.float32).eps)

# Moments tolerance, in f32 ulps of the sum of |terms|: each query-centred
# term carries <= 1 rounding from the subtraction (<= 2 more for a product
# in m2), and the k-term f32 sum adds <= k more; 64 leaves 4x margin over
# k = 15.
MOMENT_ULPS = 64.0
# Normals come from the f32 Cardano eigensolver, which resolves the
# eigenvalues only to ~sqrt(eps32) of the largest (an acos near +-1), so the
# eigenvector angle error scales as sqrt(eps32) / relative gap (measured
# ~2.5 sqrt(eps32) on well-separated rows). Rows whose f64 covariance has a
# relative gap (lambda1 - lambda0) / lambda2 >= 5% are compared, each
# within 8 sqrt(eps32) / gap radians.
NORMAL_MIN_GAP = 0.05
NORMAL_SQRT_EPS = 8.0
# ICP on an exact rigid copy of a 10K-point surface: the residual goes to
# f32 rounding, so the transform must come back within 1e-3 rad and 1 mm.
ICP_MAX_ANGLE = 1e-3
ICP_MAX_TRANS = 1e-3
# Clusters of the multi-device paths may differ from the one-card run by a
# centroid ULP (tile-local segmented sums reassociate); coordinates are
# compared after rounding to 0.1 mm (the voxel is 150 mm).
MULTI_DECIMALS = 4


class Report:
    """Prints every line with the card's name and power limit, and
    collects failed checks."""

    def __init__(self, card: str):
        self.card = card.replace("\n", " | ")
        self.failed = []

    def line(self, msg: str) -> None:
        print(f"{msg}  [{self.card}]", flush=True)

    def check(self, name: str, ok: bool, detail: str = "") -> bool:
        self.line(f"check {name}: {'pass' if ok else 'FAIL'} {detail}".rstrip())
        if not ok:
            self.failed.append(name)
        return ok

    def memory(self, name: str, compiled) -> None:
        m = compiled.memory_analysis()
        fields = (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes",
        )
        self.line(
            f"{name} memory_analysis "
            + " ".join(f"{f}={getattr(m, f, None)}" for f in fields)
        )

    def peak(self, name: str) -> None:
        import jax

        stats = jax.devices()[0].memory_stats() or {}
        self.line(
            f"{name} peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
            "(device 0, process so far)"
        )


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def _frames(rep, name, compiled, args_of, seeds):
    """Untimed warm call, then one timed frame per seed."""
    import jax

    jax.block_until_ready(compiled(*args_of(seeds[0])))
    outs, times = [], []
    for s in seeds:
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args_of(s)))
        times.append(_ms(t0))
        outs.append(out)
        rep.line(f"{name} frame seed={s} ms={times[-1]:.3f}")
    rep.line(f"{name} p50_ms_per_frame={float(np.median(times)):.3f} "
             f"frames={len(seeds)}")
    return outs


# ── Phase 1 ──────────────────────────────────────────────────────────────────


def phase_kitti(rep, data, kwargs, params, seeds):
    import bench
    from pointclouds_jax.core.cloud import make_cloud_arrays
    from pointclouds_jax.pipelines.kitti import (
        extract_clusters,
        kitti_obstacle_pipeline,
    )
    from pointclouds_jax.pipelines.parity import run_kitti_verifier

    arrs = make_cloud_arrays(data)
    t0 = time.perf_counter()
    compiled = kitti_obstacle_pipeline.lower(
        *bench.kitti_args(arrs, seeds[0]), **kwargs
    ).compile()
    rep.line(f"kitti points={len(data)} compile_s={_ms(t0) / 1e3:.3f}")
    rep.memory("kitti", compiled)
    outs = _frames(
        rep, "kitti", compiled, lambda s: bench.kitti_args(arrs, s), seeds
    )
    rep.peak("kitti")

    frames = []
    for s, out in zip(seeds, outs):
        clusters = extract_clusters(
            out, params["min_size"], params["max_size"]
        )
        flags = np.asarray(out.grid_flags)
        rep.line(
            f"kitti seed={s} ds_points="
            f"{int(np.asarray(out.downsampled_valid).sum())} cleaned="
            f"{int(np.asarray(out.cleaned_valid).sum())} clusters="
            f"{[len(c) for c in clusters]}"
        )
        rep.check(f"kitti[{s}].sor_certified", bool(out.sor_certified))
        rep.check(
            f"kitti[{s}].no_overflow",
            not flags.any() and not bool(out.obstacle_overflow),
            f"grid_flags={flags.astype(int).tolist()} obstacle_overflow="
            f"{bool(out.obstacle_overflow)}",
        )
        rep.check(f"kitti[{s}].clusters>=3", len(clusters) >= 3)
        frames.append((out, clusters, s))
    t0 = time.perf_counter()
    results = run_kitti_verifier(frames, params)
    rep.line(f"kitti f64 verifier (CPU child) s={_ms(t0) / 1e3:.3f}")
    for (_, _, s), res in zip(frames, results):
        rep.check(
            f"kitti[{s}].cluster_parity_exact",
            bool(res.get("cluster_parity_exact")),
            json.dumps({k: v for k, v in res.items() if k != "params"}),
        )
    return arrs, outs, frames


# ── Phase 2 ──────────────────────────────────────────────────────────────────


def _f64_knn(pts64, q64, k):
    """Exact f64 k nearest (self included) of each query row."""
    d2 = ((pts64[None, :, :] - q64[:, None, :]) ** 2).sum(-1)
    idx = np.argpartition(d2, k, axis=1)[:, : k + 1]
    dd = np.take_along_axis(d2, idx, axis=1)
    o = np.argsort(dd, axis=1)
    return np.take_along_axis(idx, o, axis=1), np.take_along_axis(dd, o, 1)


def check_moments(rep, centroids, valid, normals, normals_ok, cell, k,
                  viewpoint, rows, name):
    """Certified KNN moments (the pipeline's own entry, standalone at the
    same cell and k) and the pipeline's normals against f64 brute force on
    ``rows`` sampled certified rows."""
    import jax.numpy as jnp

    from pointclouds_jax.spatial.sweep import sweep_knn_moments_rows

    m1r, m2r, cnt, ok = (
        np.asarray(a)
        for a in sweep_knn_moments_rows(
            jnp.asarray(centroids), jnp.asarray(valid), np.float32(cell),
            k=k,
        )
    )
    pts = np.asarray(centroids)
    use = np.asarray(valid) & np.isfinite(pts).all(1)
    cert = np.nonzero(ok & use)[0]
    rep.line(
        f"{name} moments certified={len(cert)}/{int(use.sum())} "
        f"pipeline normals_ok={int(np.asarray(normals_ok)[use].sum())}"
    )
    rng = np.random.default_rng(0)
    sample = rng.choice(cert, size=min(rows, len(cert)), replace=False)
    pts64 = pts[use].astype(np.float64)
    q64 = pts[sample].astype(np.float64)
    worst1 = worst2 = 0.0
    ties = bad = 0
    for lo in range(0, len(sample), 64):
        idx, d2 = _f64_knn(pts64, q64[lo : lo + 64], k)
        for j in range(idx.shape[0]):
            i = sample[lo + j]
            if d2[j, k] - d2[j, k - 1] <= 1e-5 * max(d2[j, k - 1], 1e-30):
                ties += 1  # f64 k-th / (k+1)-th tie: set not unique
                continue
            rel = pts64[idx[j, :k]] - q64[lo + j]
            prods = np.stack([
                rel[:, 0] * rel[:, 0], rel[:, 1] * rel[:, 1],
                rel[:, 2] * rel[:, 2], rel[:, 0] * rel[:, 1],
                rel[:, 0] * rel[:, 2], rel[:, 1] * rel[:, 2],
            ])
            e1 = np.abs(m1r[:, i] - rel.sum(0)) / (
                MOMENT_ULPS * EPS32 * np.abs(rel).sum(0) + 1e-30
            )
            e2 = np.abs(m2r[:, i] - prods.sum(1)) / (
                MOMENT_ULPS * EPS32 * np.abs(prods).sum(1) + 1e-30
            )
            worst1 = max(worst1, float(e1.max()))
            worst2 = max(worst2, float(e2.max()))
            bad += int(cnt[i] != k or e1.max() > 1.0 or e2.max() > 1.0)
    rep.check(
        f"{name}.moments_match_f64",
        bad == 0 and len(sample) > 0,
        f"rows={len(sample)} f64_ties_skipped={ties} mismatched={bad} "
        f"worst_m1={worst1:.3g} worst_m2={worst2:.3g} (fraction of "
        f"{MOMENT_ULPS:.0f} ulps of sum|terms|)",
    )

    # Pipeline normals on its own certified rows vs the f64 PCA normal.
    nok = np.nonzero(np.asarray(normals_ok) & use)[0]
    sample = rng.choice(nok, size=min(rows, len(nok)), replace=False)
    nrm = np.asarray(normals)
    vp = np.asarray(viewpoint, np.float64)
    worst, compared, bad = 0.0, 0, 0
    q64 = pts[sample].astype(np.float64)
    for lo in range(0, len(sample), 64):
        idx, _ = _f64_knn(pts64, q64[lo : lo + 64], k)
        for j in range(idx.shape[0]):
            i = sample[lo + j]
            nb = pts64[idx[j, :k]]
            w, v = np.linalg.eigh(np.cov(nb.T, bias=True))
            gap = (w[1] - w[0]) / max(w[2], 1e-30)
            if gap < NORMAL_MIN_GAP:
                continue
            n64 = v[:, 0]
            if n64 @ (vp - q64[lo + j]) < 0:
                n64 = -n64
            ang = float(np.arccos(np.clip(n64 @ nrm[i], -1.0, 1.0)))
            limit = NORMAL_SQRT_EPS * np.sqrt(EPS32) / gap
            worst = max(worst, ang / limit)
            compared += 1
            bad += int(ang > limit)
    rep.check(
        f"{name}.normals_match_f64",
        bad == 0 and compared > 0,
        f"rows={compared} mismatched={bad} worst={worst:.3g} (fraction of "
        f"the {NORMAL_SQRT_EPS:.0f} sqrt(eps32)/gap limit)",
    )


def phase_aerial(rep, data, kwargs, seeds):
    import bench
    from pointclouds_jax.core.cloud import make_cloud_arrays
    from pointclouds_jax.pipelines.aerial import aerial_pipeline

    arrs = make_cloud_arrays(data)
    t0 = time.perf_counter()
    compiled = aerial_pipeline.lower(
        *bench.aerial_args(arrs, seeds[0]), **kwargs
    ).compile()
    rep.line(f"aerial points={len(data)} compile_s={_ms(t0) / 1e3:.3f}")
    rep.memory("aerial", compiled)
    outs = _frames(
        rep, "aerial", compiled, lambda s: bench.aerial_args(arrs, s), seeds
    )
    rep.peak("aerial")
    for s, out in zip(seeds, outs):
        rep.line(
            f"aerial seed={s} ds_points="
            f"{int(np.asarray(out.downsampled_valid).sum())} obstacles="
            f"{int(np.asarray(out.obstacle_valid).sum())}"
        )
        rep.check(f"aerial[{s}].cluster_exact", bool(out.cluster_exact))
        rep.check(
            f"aerial[{s}].no_overflow",
            not bool(out.ds_overflow) and not bool(out.obstacle_overflow),
            f"ds_overflow={bool(out.ds_overflow)} obstacle_overflow="
            f"{bool(out.obstacle_overflow)}",
        )
    out = outs[-1]
    check_moments(
        rep, out.centroids, out.downsampled_valid, out.normals,
        out.normals_ok, bench.AERIAL_PARAMS["normals_cell"],
        15, bench.AERIAL_VIEWPOINT, MOMENT_SAMPLE_ROWS, "aerial",
    )
    return arrs, outs


# ── Phase 3 ──────────────────────────────────────────────────────────────────


def _rotation(axis, angle):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def icp_pair(n, seed=0):
    """(source, target, R, t) with R @ source + t == target: a smooth
    non-symmetric surface, so point-to-plane ICP has one alignment."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-5.0, 5.0, (2, n))
    z = 0.6 * np.sin(0.8 * x) * np.cos(0.6 * y) + 0.25 * np.sin(1.7 * y + 0.3)
    tgt = np.column_stack([x, y, z]).astype(np.float32)
    rot = _rotation([0.3, -0.2, 0.93], np.deg2rad(3.0))
    t = np.array([0.12, -0.08, 0.05])
    src = ((tgt.astype(np.float64) - t) @ rot).astype(np.float32)
    return src, tgt, rot, t


def phase_per_op(rep, data, params, fused_frame, icp_points):
    import pointclouds_rs as prs
    from pointclouds_jax.pipelines.parity import (
        clusters_equal,
        fused_cluster_points,
    )

    out, fused_clusters, seed = fused_frame

    def chain():
        cloud = prs.PointCloud.from_numpy(data)
        ds = prs.voxel_downsample(cloud, params["voxel"])
        cleaned = prs.statistical_outlier_removal(
            ds, params["sor_k"], params["sor_std"]
        )
        plane = prs.ransac_plane_seeded(
            cleaned, params["ransac_thresh"], params["ransac_iters"], seed
        )
        obstacles = cleaned.select_inverse(plane.inliers)
        clusters = prs.euclidean_cluster(
            obstacles, params["cluster_r"], params["min_size"],
            params["max_size"],
        )
        obs = obstacles.to_numpy()
        return [obs[c] for c in clusters]

    for attempt in ("first (compiles)", "second"):
        t0 = time.perf_counter()
        api_pts = chain()
        rep.line(f"per-op chain {attempt} call ms={_ms(t0):.3f}")
    rep.check(
        "per_op.clusters_equal_fused",
        clusters_equal(api_pts, fused_cluster_points(out, fused_clusters)),
        f"per_op={[len(p) for p in api_pts]} "
        f"fused={[len(c) for c in fused_clusters]}",
    )

    src, tgt, rot, t = icp_pair(icp_points)
    target = prs.estimate_normals(prs.PointCloud.from_numpy(tgt), 10)
    source = prs.PointCloud.from_numpy(src)
    for attempt in ("first (compiles)", "second"):
        t0 = time.perf_counter()
        res = prs.icp_point_to_plane(
            source, target, max_iterations=50, tolerance=1e-9
        )
        rep.line(f"icp_point_to_plane {attempt} call ms={_ms(t0):.3f} "
                 f"iterations={res.num_iterations} rmse={res.rmse:.3g}")
    r_est = np.asarray(res.rotation, np.float64)
    cos = (np.trace(r_est.T @ rot) - 1.0) / 2.0
    ang = float(np.arccos(np.clip(cos, -1.0, 1.0)))
    dt = float(np.linalg.norm(np.asarray(res.translation) - t))
    rep.check(
        "icp.recovers_transform",
        ang <= ICP_MAX_ANGLE and dt <= ICP_MAX_TRANS,
        f"points={icp_points} rotation_error_rad={ang:.3g} (limit "
        f"{ICP_MAX_ANGLE}) translation_error_m={dt:.3g} (limit "
        f"{ICP_MAX_TRANS})",
    )


# ── Phase 4 ──────────────────────────────────────────────────────────────────


def _stage(rep, name, fn):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(STAGE_REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(_ms(t0))
    rep.line(f"stage {name} ms_per_call={float(np.median(ts)):.3f} "
             f"(median of {STAGE_REPS})")


def phase_stages(rep, kitti, aerial):
    """kitti/aerial: (arrs, last output, kwargs) of phases 1 and 2."""
    from functools import partial

    import jax.numpy as jnp

    import bench
    from pointclouds_jax.ops.filters import voxel_downsample_sweep_fused
    from pointclouds_jax.ops.segmentation import ransac_plane_masked
    from pointclouds_jax.spatial.sweep import (
        sweep_cluster_labels,
        sweep_knn_moments_rows,
        sweep_sor_two_pass,
    )

    karrs, kout, kkw = kitti
    kp = bench.KITTI_PARAMS
    kobs = jnp.take(kout.centroids, kout.obstacle_src, axis=0)
    aarrs, aout, akw = aerial
    ap = bench.AERIAL_PARAMS
    aobs = jnp.take(aout.centroids, aout.obstacle_src, axis=0)
    stages = [
        ("kitti voxel_sort_segscan", partial(
            voxel_downsample_sweep_fused, karrs.xyz, karrs.valid,
            np.float32(kp["voxel"]), factor=3, ds_cap=kkw["ds_cap"])),
        ("kitti sor_two_pass", partial(
            sweep_sor_two_pass, kout.centroids, kout.downsampled_valid,
            np.float32(kp["voxel"] * 3.0), k=kp["sor_k"], fix_cap=4096,
            rescue_cells=8.0, per_seg=2, with_lb=True)),
        ("kitti ransac", partial(
            ransac_plane_masked, kout.centroids, kout.cleaned_valid,
            np.float32(kp["ransac_thresh"]), np.int32(0), kp["ransac_iters"],
            score_subsample=kp["ransac_subsample"])),
        ("kitti cluster", partial(
            sweep_cluster_labels, kobs, kout.obstacle_valid,
            np.float32(kp["cluster_r"]), wr=12)),
        ("aerial voxel_sort_segscan", partial(
            voxel_downsample_sweep_fused, aarrs.xyz, aarrs.valid,
            np.float32(ap["voxel"]), factor=akw["normals_cell_factor"],
            ds_cap=akw["ds_cap"])),
        ("aerial knn_moments", partial(
            sweep_knn_moments_rows, aout.centroids, aout.downsampled_valid,
            np.float32(ap["normals_cell"]), k=15)),
        ("aerial ransac", partial(
            ransac_plane_masked, aout.centroids, aout.downsampled_valid,
            np.float32(ap["ransac_thresh"]), np.int32(0), 300,
            assume_compact=True, score_subsample=akw["ransac_subsample"])),
        ("aerial cluster", partial(
            sweep_cluster_labels, aobs, aout.obstacle_valid,
            np.float32(ap["cluster_r"]), wr=12, rep_labels=False)),
    ]
    for name, fn in stages:
        _stage(rep, name, fn)


# ── --four-cards ─────────────────────────────────────────────────────────────


def phase_four_cards(rep, scenes, kwargs, params):
    """Tiled (frames:2 x points:2) and sharded (frames:4) KITTI against the
    one-card pipeline on device 0, frame by frame."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from pointclouds_jax.core.cloud import make_cloud_arrays
    from pointclouds_jax.parallel.sharding import (
        make_mesh,
        sharded_kitti_pipeline,
    )
    from pointclouds_jax.parallel.tiles import tiled_kitti_pipeline
    from pointclouds_jax.pipelines.kitti import (
        extract_clusters,
        kitti_obstacle_pipeline,
    )
    from pointclouds_jax.pipelines.parity import (
        clusters_equal,
        fused_cluster_points,
    )

    frames = [make_cloud_arrays(s) for s in scenes]
    b = len(frames)
    seeds = np.arange(b, dtype=np.int32)
    scalars = tuple(
        np.float32(params[k])
        for k in ("voxel", "sor_std", "ransac_thresh")
    )
    cluster_r = np.float32(params["cluster_r"])

    ref = []
    for s, f in enumerate(frames):
        out = kitti_obstacle_pipeline(
            *bench.kitti_args(f, s), **kwargs
        )
        cl = extract_clusters(out, params["min_size"], params["max_size"])
        ref.append(fused_cluster_points(out, cl))
    rep.line("one-card reference clusters (device 0): "
             f"{[[len(p) for p in r] for r in ref]}")

    def clusters_of(xyz, valid, labels):
        xyz, valid, labels = (np.asarray(a) for a in (xyz, valid, labels))
        out = []
        for lab in np.unique(labels[valid]):
            rows = np.nonzero(valid & (labels == lab))[0]
            if params["min_size"] <= len(rows) <= params["max_size"]:
                out.append(xyz[rows])
        return out

    def run(name, mesh, step, xs_spec, v_spec):
        xs = jax.device_put(
            jnp.stack([f.xyz for f in frames]), NamedSharding(mesh, xs_spec)
        )
        vs = jax.device_put(
            jnp.stack([f.valid for f in frames]), NamedSharding(mesh, v_spec)
        )
        sd = jax.device_put(seeds, NamedSharding(mesh, P("frames")))
        args = (xs, vs, *scalars, sd, cluster_r)
        t0 = time.perf_counter()
        out = jax.block_until_ready(step(*args))
        rep.line(f"{name} mesh={dict(mesh.shape)} first call (compiles) "
                 f"s={_ms(t0) / 1e3:.3f}")
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = jax.block_until_ready(step(*args))
            ts.append(_ms(t0))
        rep.line(f"{name} ms_per_batch_of_{b}={float(np.median(ts)):.3f} "
                 "(median of 3)")
        rep.line(f"{name} output devices="
                 f"{sorted(d.id for d in out.labels.sharding.device_set)}")
        return out

    mesh = make_mesh(4, points=2)
    step = tiled_kitti_pipeline(
        mesh, frames[0].capacity, sor_k=kwargs["sor_k"],
        ransac_iters=kwargs["ransac_iters"],
        ransac_subsample=kwargs["ransac_subsample"],
        obstacle_cap=kwargs["obstacle_cap"],
    )
    out = run("tiled", mesh, step, P("frames", "points", None),
              P("frames", "points"))
    for i in range(b):
        flags = np.asarray(out.flags[i])
        # The tiled SOR rescues only within its halo (4 cells), so its
        # per-frame certificate is reported; the cluster comparison with
        # the one-card run below is the gate.
        rep.check(
            f"tiled[{i}].flags_clean",
            not flags.any() and bool(out.cluster_exact[i]),
            f"flags={flags.astype(int).tolist()} sor_certified="
            f"{bool(out.sor_certified[i])} cluster_exact="
            f"{bool(out.cluster_exact[i])}",
        )
        got = clusters_of(out.obstacle_xyz[i], out.obstacle_valid[i],
                          out.labels[i])
        rep.check(
            f"tiled[{i}].clusters_equal_one_card",
            clusters_equal(got, ref[i], decimals=MULTI_DECIMALS),
            f"tiled={[len(p) for p in got]}",
        )

    mesh = make_mesh(4, points=1)
    step = sharded_kitti_pipeline(mesh, **kwargs)
    out = run("sharded", mesh, step, P("frames", "points", None),
              P("frames", "points"))
    for i in range(b):
        frame = jax.tree_util.tree_map(lambda a: a[i], out)
        flags = np.asarray(frame.grid_flags)
        rep.check(
            f"sharded[{i}].flags_clean",
            not flags.any() and bool(frame.sor_certified)
            and not bool(frame.obstacle_overflow),
            f"grid_flags={flags.astype(int).tolist()} sor_certified="
            f"{bool(frame.sor_certified)} obstacle_overflow="
            f"{bool(frame.obstacle_overflow)}",
        )
        cl = extract_clusters(frame, params["min_size"], params["max_size"])
        got = fused_cluster_points(frame, cl)
        rep.check(
            f"sharded[{i}].clusters_equal_one_card",
            clusters_equal(got, ref[i], decimals=MULTI_DECIMALS),
            f"sharded={[len(p) for p in got]}",
        )


# ── Driver ───────────────────────────────────────────────────────────────────


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the multi-device KITTI paths on four GPUs",
    )
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax

    import bench
    from pointclouds_jax.pipelines.scenes import aerial_scene, velodyne_scene
    from pointclouds_jax.utils.profiling import (
        device_line,
        gpu_card,
        require_gpu,
    )

    require_gpu(4 if args.four_cards else 1)
    devs = jax.devices()
    card = gpu_card()
    for ln in card.splitlines():
        print(ln, flush=True)
    rep = Report(card or "nvidia-smi unavailable")
    rep.line(device_line())
    t_start = time.perf_counter()
    try:
        if args.four_cards:
            scenes = [velodyne_scene(seed=s) for s in range(4)]
            phase_four_cards(rep, scenes, bench.KITTI_KWARGS,
                             bench.KITTI_PARAMS)
        else:
            data = velodyne_scene(seed=0, n_points=bench.N_POINTS)
            seeds = list(range(KITTI_FRAMES))
            karrs, kouts, kframes = phase_kitti(
                rep, data, bench.KITTI_KWARGS, bench.KITTI_PARAMS, seeds
            )
            rep.line(f"phase 1 done at s={_ms(t_start) / 1e3:.3f}")
            aarrs, aouts = phase_aerial(
                rep, aerial_scene(seed=42, scale=1.0), bench.AERIAL_KWARGS,
                list(range(AERIAL_FRAMES)),
            )
            rep.line(f"phase 2 done at s={_ms(t_start) / 1e3:.3f}")
            phase_per_op(rep, data, bench.KITTI_PARAMS, kframes[0], 10_000)
            rep.line(f"phase 3 done at s={_ms(t_start) / 1e3:.3f}")
            phase_stages(
                rep, (karrs, kouts[-1], bench.KITTI_KWARGS),
                (aarrs, aouts[-1], bench.AERIAL_KWARGS),
            )
            rep.line(f"phase 4 done at s={_ms(t_start) / 1e3:.3f}")
    except Exception:
        traceback.print_exc()
        rep.failed.append("exception")
    if rep.failed:
        print(f"chip_smoke: FAILED {rep.failed}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
