"""Large-cloud differential tests for the sweep-backed engine ops
(engine.sor_means / radius_count_sweep / normals): clouds above
BRUTE_THRESHOLD so the sweep + brute-rescue path actually runs, including
scattered sparse points that force the rescue."""

import numpy as np
import jax.numpy as jnp

import pointclouds_jax as pc
from pointclouds_jax.core.cloud import make_cloud_arrays
from pointclouds_jax.spatial import engine


def _make_cloud(n=6000, seed=0, with_sparse=True):
    rng = np.random.default_rng(seed)
    parts = [
        (rng.random((n // 2, 3)) * 8).astype(np.float32),
        rng.normal([4, 4, 1], 0.2, (n // 4, 3)).astype(np.float32),
    ]
    rest = n - n // 2 - n // 4
    if with_sparse:
        # isolated far-field points: guaranteed sweep-certificate failures
        parts.append((rng.random((rest, 3)) * 200 - 100).astype(np.float32))
    else:
        parts.append((rng.random((rest, 3)) * 8).astype(np.float32))
    return np.vstack(parts).astype(np.float32)


def test_sor_means_matches_brute():
    pts = _make_cloud()
    arrs = make_cloud_arrays(pts)
    k = 12
    means = np.asarray(engine.sor_means(arrs.xyz, arrs.valid, k))
    expect = np.asarray(
        engine._brute_sor_means(arrs.xyz, arrs.valid, k)
    )
    n = len(pts)
    np.testing.assert_allclose(means[:n], expect[:n], rtol=1e-5, atol=1e-6)


def test_radius_count_sweep_matches_brute():
    pts = _make_cloud(seed=1)
    arrs = make_cloud_arrays(pts)
    r = 0.7
    counts = np.asarray(engine.radius_count_sweep(arrs.xyz, arrs.valid, r))
    expect = np.asarray(
        engine.bruteforce_radius_count(
            arrs.xyz, arrs.valid, arrs.xyz, arrs.valid, r
        )
    )
    n = len(pts)
    np.testing.assert_array_equal(counts[:n], expect[:n])


def test_normals_match_brute_knn():
    pts = _make_cloud(seed=2, with_sparse=False)
    arrs = make_cloud_arrays(pts)
    k = 10
    vp = (0.0, 0.0, 100.0)
    nrm = np.asarray(engine.normals(arrs.xyz, arrs.valid, k, vp))
    from pointclouds_jax.ops.normals import normals_from_knn
    from pointclouds_jax.spatial.knn import bruteforce_knn

    _, idx, nvalid = bruteforce_knn(
        arrs.xyz, arrs.valid, arrs.xyz, arrs.valid, k
    )
    expect = np.asarray(
        normals_from_knn(arrs.xyz, idx, nvalid, jnp.asarray(vp, jnp.float32))
    )
    n = len(pts)
    dots = np.abs(np.sum(nrm[:n] * expect[:n], axis=1))
    assert np.percentile(dots, 2) > 0.999


def test_api_sor_large_cloud_matches_small_path():
    # Public API on a >threshold cloud must equal the brute verdict.
    pts = _make_cloud(seed=3)
    cloud = pc.PointCloud.from_numpy(pts)
    out = pc.statistical_outlier_removal(cloud, 10, 2.0)
    means = np.asarray(
        engine._brute_sor_means(cloud._arrs.xyz, cloud._arrs.valid, 10)
    )[: len(pts)]
    finite = np.isfinite(means)
    mu = means[finite].mean()
    sd = np.sqrt(((means[finite] - mu) ** 2).mean())
    expect_keep = means <= mu + 2.0 * sd
    assert out.len() == int(expect_keep.sum())


def test_api_ror_large_cloud():
    pts = _make_cloud(seed=4)
    cloud = pc.PointCloud.from_numpy(pts)
    r, m = 0.6, 8
    out = pc.radius_outlier_removal(cloud, r, m)
    counts = np.asarray(
        engine.bruteforce_radius_count(
            cloud._arrs.xyz, cloud._arrs.valid,
            cloud._arrs.xyz, cloud._arrs.valid, r,
        )
    )[: len(pts)]
    assert out.len() == int((counts >= m).sum())


def test_engine_knn_sweep_path_matches_oracle():
    # Same-cloud all-points KNN: the sweep fast path must return exactly
    # the brute-force distances (indices may reorder only at exact ties).
    pts = _make_cloud(seed=5)
    arrs = make_cloud_arrays(pts)
    k = 8
    dists, idx, nvalid = engine.knn(arrs.xyz, arrs.valid, arrs.xyz, arrs.valid, k)
    ed, ei, ev = engine.bruteforce_knn(
        arrs.xyz, arrs.valid, arrs.xyz, arrs.valid, k
    )
    n = len(pts)
    np.testing.assert_allclose(
        np.asarray(dists)[:n], np.asarray(ed)[:n], rtol=1e-5, atol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(nvalid)[:n], np.asarray(ev)[:n]
    )
    # indices agree wherever the (k)th distance is strictly unique
    d = np.asarray(dists)[:n]
    same = np.asarray(idx)[:n] == np.asarray(ei)[:n]
    uniq = np.ones_like(same)
    uniq[:, :-1] &= d[:, :-1] != d[:, 1:]
    uniq[:, 1:] &= d[:, 1:] != d[:, :-1]
    assert (same | ~uniq).all()


def test_engine_radius_count_sweep_dense_clump_matches_f64():
    """A dense clump overflows the sweep windows: engine.radius_count_sweep
    must fall back to its exact per-row rescue and match f64 counts."""
    rng = np.random.default_rng(4)
    pts = np.vstack([
        (rng.random((3000, 3)) * 10).astype(np.float32),
        (rng.random((1096, 3)) * 0.4 + 5.0).astype(np.float32),
    ])
    arrs = make_cloud_arrays(pts)
    r = 0.5
    counts = np.asarray(
        engine.radius_count_sweep(arrs.xyz, arrs.valid, r)
    )[: len(pts)]
    p64 = pts.astype(np.float64)
    d = np.sqrt(((p64[:, None, :] - p64[None]) ** 2).sum(-1))
    lo = (d <= r * (1 - 1e-6)).sum(1)
    hi = (d <= r * (1 + 1e-6)).sum(1)
    assert ((counts >= lo) & (counts <= hi)).all()


def test_engine_knn_cross_cloud_matches_oracle():
    """Cross-cloud batched KNN (queries != the cloud's own points) routes
    through the fused query-frame sweep (sweep_knn_cross_two_pass) and
    must return exactly the brute-force distances — including queries
    OUTSIDE the point grid, invalid queries, and a non-finite query."""
    pts = _make_cloud(seed=6)
    rng = np.random.default_rng(7)
    q = np.vstack([
        (rng.random((2500, 3)) * 8).astype(np.float32),
        (rng.random((400, 3)) * 300 - 150).astype(np.float32),  # far field
    ]).astype(np.float32)
    q[11] = np.nan
    qv = rng.random(len(q)) > 0.05
    arrs = make_cloud_arrays(pts)
    qa = make_cloud_arrays(q)
    qvj = jnp.logical_and(qa.valid, jnp.asarray(
        np.concatenate([qv, np.zeros(qa.valid.shape[0] - len(q), bool)])))
    k = 7
    dists, idx, nvalid = engine.knn(arrs.xyz, arrs.valid, qa.xyz, qvj, k)
    ed, ei, ev = engine.bruteforce_knn(arrs.xyz, arrs.valid, qa.xyz, qvj, k)
    nq = len(q)
    np.testing.assert_allclose(
        np.asarray(dists)[:nq], np.asarray(ed)[:nq], rtol=1e-5, atol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(nvalid)[:nq], np.asarray(ev)[:nq]
    )
    d = np.asarray(dists)[:nq]
    same = np.asarray(idx)[:nq] == np.asarray(ei)[:nq]
    uniq = np.ones_like(same)
    uniq[:, :-1] &= d[:, :-1] != d[:, 1:]
    uniq[:, 1:] &= d[:, 1:] != d[:, :-1]
    assert (same | ~uniq).all()
    assert not np.asarray(nvalid)[11].any()  # NaN query -> no results


def test_sweep_knn_cross_matches_f64():
    """Cross-cloud sweep KNN (queries partly outside the point AABB):
    certified rows carry the f64 k nearest distances and indices."""
    from scipy.spatial import cKDTree

    from pointclouds_jax.spatial.sweep import sweep_knn_cross_two_pass

    rng = np.random.default_rng(8)
    p = (rng.random((2048, 3)) * 5).astype(np.float32)
    q = (rng.random((1024, 3)) * 5.4 - 0.2).astype(np.float32)
    pv = jnp.ones(2048, bool)
    qv = jnp.ones(1024, bool)
    d, i, nv, ok = map(np.asarray, sweep_knn_cross_two_pass(
        jnp.asarray(p), pv, jnp.asarray(q), qv, np.float32(0.35), k=5,
    ))
    assert ok.mean() > 0.95
    wd, wi = cKDTree(p.astype(np.float64)).query(q.astype(np.float64), k=5)
    assert nv[ok].all()
    np.testing.assert_allclose(d[ok], wd[ok], rtol=1e-5, atol=1e-6)
    assert (i[ok] == wi[ok]).mean() > 0.9999  # ties only
