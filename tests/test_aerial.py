"""Fused aerial pipeline vs the exact per-op engine path
(pipelines/aerial.py; ref workload: examples/python/aerial_lidar.py:143-186)."""

import numpy as np
import jax.numpy as jnp

import pointclouds_jax as pc
from pointclouds_jax.core.cloud import make_cloud_arrays
from pointclouds_jax.pipelines.aerial import aerial_pipeline, extract_clusters
from pointclouds_jax.pipelines.scenes import aerial_scene

SCALE = 0.05
NORMALS_CELL = 12.0  # ~3x the k=15 radius at the tiny test scale's density


def _run(seed=0):
    data = aerial_scene(seed=42, scale=SCALE)
    arrs = make_cloud_arrays(data)
    out = aerial_pipeline(
        arrs.xyz,
        arrs.valid,
        np.float32(0.5),
        np.float32(NORMALS_CELL),
        np.float32(0.3),
        seed,
        np.float32(2.0),
        jnp.asarray([0.0, 0.0, 10000.0], jnp.float32),
    )
    return data, out


def test_aerial_normals_match_exact_engine():
    data, out = _run()
    ds_valid = np.asarray(out.downsampled_valid)
    cents = np.asarray(out.centroids)[ds_valid]
    nok = np.asarray(out.normals_ok)[ds_valid]
    fused_n = np.asarray(out.normals)[ds_valid]

    # Exact path: public API normals on the same downsampled cloud.
    cloud = pc.PointCloud.from_numpy(np.ascontiguousarray(cents))
    with_normals = pc.estimate_normals_with_viewpoint(
        cloud, 15, (0.0, 0.0, 10000.0)
    )
    exact_n = with_normals._normals_numpy()

    assert nok.sum() > 0.8 * len(cents)
    sel = np.nonzero(nok)[0]
    dots = np.abs(np.sum(fused_n[sel] * exact_n[sel], axis=1))
    # certified rows: same neighbor sets => same plane, up to eigensolver
    # tolerance on near-degenerate neighborhoods
    assert np.percentile(dots, 5) > 0.999
    assert dots.mean() > 0.999


def test_aerial_uncertified_normals_close_to_exact():
    """Rows the moments sweep could NOT certify still estimate from the
    candidates found; validate them against the exact engine. A deliberately
    small certification cell (4.0 at this density) flags ~95% of rows, so
    this exercises the uncertified path at scale. Measured quality: the
    overwhelming majority of flagged rows still find their true k nearest
    (median |dot| ~0.999999); a small residual of genuinely sparse-region
    rows may differ (documented approximation, pipelines/aerial.py)."""
    data = aerial_scene(seed=42, scale=SCALE)
    arrs = make_cloud_arrays(data)
    out = aerial_pipeline(
        arrs.xyz,
        arrs.valid,
        np.float32(0.5),
        np.float32(4.0),  # too small to certify -> most rows flagged
        np.float32(0.3),
        0,
        np.float32(2.0),
        jnp.asarray([0.0, 0.0, 10000.0], jnp.float32),
    )
    ds_valid = np.asarray(out.downsampled_valid)
    cents = np.asarray(out.centroids)[ds_valid]
    nok = np.asarray(out.normals_ok)[ds_valid]
    fused_n = np.asarray(out.normals)[ds_valid]

    cloud = pc.PointCloud.from_numpy(np.ascontiguousarray(cents))
    with_normals = pc.estimate_normals_with_viewpoint(
        cloud, 15, (0.0, 0.0, 10000.0)
    )
    exact_n = with_normals._normals_numpy()

    flagged = np.nonzero(~nok)[0]
    assert len(flagged) > 1000  # the small cell must actually flag rows
    dots = np.abs(np.sum(fused_n[flagged] * exact_n[flagged], axis=1))
    assert np.median(dots) > 0.999
    assert (dots > 0.99).mean() > 0.95
    # And every flagged normal is still unit length (not garbage).
    norms = np.linalg.norm(fused_n[flagged], axis=1)
    assert np.all(np.abs(norms - 1.0) < 1e-3)


def test_aerial_clusters_match_engine():
    data, out = _run()
    assert bool(out.cluster_exact)
    fused = extract_clusters(out, 20, 100_000)

    ds_valid = np.asarray(out.downsampled_valid)
    cents = np.asarray(out.centroids)[ds_valid]
    inl = np.asarray(out.inlier_mask)[ds_valid]
    objects = pc.PointCloud.from_numpy(np.ascontiguousarray(cents[~inl]))
    exact = pc.euclidean_cluster(objects, 2.0, 20, 100_000)

    # Same obstacle sub-cloud (fused obstacle order = compacted ds order =
    # row order of cents[~inl]), so index sets must match exactly.
    fused_sets = sorted(tuple(c) for c in fused)
    # map fused obstacle-slot indices to rows of the ~inl sub-cloud
    obs_src = np.asarray(out.obstacle_src)
    obs_valid = np.asarray(out.obstacle_valid)
    ds_rows = np.nonzero(ds_valid)[0]
    row_of_centroid = {int(r): i for i, r in enumerate(ds_rows)}
    nonground_rows = np.nonzero(~inl)[0]
    sub_of_row = {int(r): i for i, r in enumerate(nonground_rows)}
    remapped = []
    for c in fused:
        rows = [row_of_centroid[int(obs_src[s])] for s in c]
        remapped.append(tuple(sorted(sub_of_row[r] for r in rows)))
    assert sorted(remapped) == sorted(tuple(c) for c in exact)


def test_aerial_ground_plane_sane():
    data, out = _run()
    n = np.asarray(out.plane_normal)
    assert abs(n[2]) > 0.95  # terrain is near-horizontal
    assert int(np.asarray(out.inlier_mask).sum()) > 1000


def test_aerial_normals_rescue_raises_certification():
    """normals_rescue=True routes the flagged rows through the pruned
    exact rescue: certification must rise substantially and certified
    normals must agree between the two modes."""
    data = aerial_scene(seed=3, scale=0.1)
    arrs = make_cloud_arrays(data)
    vp = jnp.asarray([0.0, 0.0, 10000.0], jnp.float32)
    outs = {}
    for rescue in (False, True):
        outs[rescue] = aerial_pipeline(
            arrs.xyz, arrs.valid, np.float32(0.5), np.float32(3.0),
            np.float32(0.3), 0, np.float32(2.0), vp,
            normals_rescue=rescue,
        )
    ds_valid = np.asarray(outs[False].downsampled_valid)
    nok0 = np.asarray(outs[False].normals_ok)[ds_valid]
    nok1 = np.asarray(outs[True].normals_ok)[ds_valid]
    assert nok1.sum() > nok0.sum()
    # The 0.1-scale scene is far sparser than production (many kth
    # neighbors fall outside even the 4-cell rescue ball), so full
    # certification isn't reachable here — require a substantial uplift.
    assert nok1.mean() > nok0.mean() + 0.05

    # Normals agreement on rows certified by BOTH modes (orientation
    # included): the rescue must not perturb already-exact rows.
    na = np.asarray(outs[False].normals)
    nb = np.asarray(outs[True].normals)
    if na.ndim == 2 and na.shape[0] == 3:
        na, nb = na.T, nb.T
    both = nok0 & nok1[: len(nok0)]
    dots = np.abs(np.sum(na[ds_valid][both] * nb[ds_valid][both], axis=1))
    assert (dots > 1.0 - 1e-5).mean() > 0.999
