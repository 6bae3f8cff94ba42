"""Host cell index (build-once single-query path) vs f64 brute force."""

import numpy as np
import pytest

import pointclouds_jax as pc
from pointclouds_jax.spatial.hostindex import HostCellIndex


def _cloud(seed=0, n=5000):
    rng = np.random.default_rng(seed)
    return rng.uniform(-10, 10, (n, 3)).astype(np.float32)


def test_radius_matches_brute():
    xyz = _cloud()
    idx = HostCellIndex(xyz, np.ones(len(xyz), bool))
    rng = np.random.default_rng(1)
    for _ in range(50):
        q = rng.uniform(-12, 12, 3)
        r = rng.uniform(0.2, 3.0)
        got = idx.radius(q, r)
        d2 = ((xyz.astype(np.float64) - q) ** 2).sum(1)
        want = np.nonzero(d2 <= r * r)[0]
        np.testing.assert_array_equal(got, want)


def test_knn_matches_brute():
    xyz = _cloud(2)
    idx = HostCellIndex(xyz, np.ones(len(xyz), bool))
    rng = np.random.default_rng(3)
    for _ in range(50):
        q = rng.uniform(-12, 12, 3)
        k = int(rng.integers(1, 20))
        rows, dists = idx.knn(q, k)
        d = np.sqrt(((xyz.astype(np.float64) - q) ** 2).sum(1))
        want = np.sort(d)[:k]
        np.testing.assert_allclose(np.sort(dists), want, rtol=1e-12)


def test_knn_k_exceeds_population():
    xyz = _cloud(4, 7)
    idx = HostCellIndex(xyz, np.ones(7, bool))
    rows, dists = idx.knn(np.zeros(3), 20)
    assert len(rows) == 7
    assert (np.diff(dists) >= 0).all()


def test_invalid_and_nonfinite_rows_excluded():
    xyz = _cloud(5, 100)
    valid = np.ones(100, bool)
    valid[10:20] = False
    xyz[30] = np.nan
    idx = HostCellIndex(xyz, valid)
    got = idx.radius(xyz[0], 50.0)
    assert 0 in got
    assert not any(10 <= g < 20 for g in got)
    assert 30 not in got


def test_far_outside_query():
    xyz = _cloud(6, 500)
    idx = HostCellIndex(xyz, np.ones(500, bool))
    q = np.array([1e4, 1e4, 1e4])
    rows, dists = idx.knn(q, 3)
    d = np.sqrt(((xyz.astype(np.float64) - q) ** 2).sum(1))
    np.testing.assert_allclose(np.sort(dists), np.sort(d)[:3], rtol=1e-12)


def test_api_radius_search_uses_index_and_caches():
    cloud = pc.PointCloud.from_numpy(_cloud(7, 3000))
    r1 = pc.radius_search(cloud, (0.0, 0.0, 0.0), 2.0)
    assert getattr(cloud, "_host_index", None) is not None
    idx_obj = cloud._host_index
    r2 = pc.radius_search(cloud, (1.0, 1.0, 1.0), 2.0)
    assert cloud._host_index is idx_obj  # reused, not rebuilt
    xyz = np.asarray(cloud.to_numpy(), np.float64)
    for q, got in (((0.0, 0.0, 0.0), r1), ((1.0, 1.0, 1.0), r2)):
        d2 = ((xyz - np.asarray(q)) ** 2).sum(1)
        np.testing.assert_array_equal(got, np.nonzero(d2 <= 4.0)[0])


def test_api_radius_search_batched_superset():
    cloud = pc.PointCloud.from_numpy(_cloud(8, 2000))
    qs = np.array([[0, 0, 0], [5, 5, 5], [np.nan, 0, 0]], np.float32)
    out = pc.radius_search(cloud, qs, 1.5)
    assert isinstance(out, list) and len(out) == 3
    assert out[2] == []
    xyz = np.asarray(cloud.to_numpy(), np.float64)
    for q, got in zip(qs[:2], out[:2]):
        d2 = ((xyz - q.astype(np.float64)) ** 2).sum(1)
        np.testing.assert_array_equal(got, np.nonzero(d2 <= 1.5 * 1.5)[0])


def test_api_knn_small_batch_matches_brute():
    data = _cloud(9, 4000)
    cloud = pc.PointCloud.from_numpy(data)
    qs = _cloud(10, 5)
    i, d = pc.knn(cloud, qs, 8)
    assert i.shape == (5, 8)
    for r in range(5):
        dd = np.sqrt(
            ((data.astype(np.float64) - qs[r].astype(np.float64)) ** 2).sum(1)
        )
        np.testing.assert_allclose(np.sort(d[r]), np.sort(dd)[:8], rtol=1e-6)


def test_native_index_matches_numpy_path(monkeypatch):
    """The C++ index (native/pcindex.cpp) must reproduce the numpy
    HostCellIndex exactly: same rows, same distances, same tie order."""
    import pointclouds_jax.spatial.hostindex as hi
    from pointclouds_jax import native

    if native.create_index(np.zeros((1, 3), np.float32),
                           np.ones(1, bool)) is None:
        import pytest

        pytest.skip("native index unavailable (no toolchain)")

    rng = np.random.default_rng(7)
    pts = (rng.random((5000, 3)) * 10).astype(np.float32)
    pts[17] = np.nan  # non-finite row must be excluded
    valid = np.ones(len(pts), bool)
    valid[23] = False

    ix_native = hi.HostCellIndex(pts, valid)
    assert ix_native._native is not None
    monkeypatch.setattr(native, "create_index", lambda *a: None)
    ix_numpy = hi.HostCellIndex(pts, valid)
    assert ix_numpy._native is None

    queries = np.vstack(
        [pts[rng.integers(0, len(pts), 20)] + 0.003,
         (rng.random((5, 3)) * 14 - 2).astype(np.float32)]
    )
    for q in queries:
        rn, dn = ix_native.knn(q, 8)
        rp, dp = ix_numpy.knn(q, 8)
        assert list(rn) == list(rp)
        np.testing.assert_allclose(dn, dp, rtol=0, atol=0)
        hn = ix_native.radius(q, 0.4)
        hp = ix_numpy.radius(q, 0.4)
        assert list(hn) == list(hp)


def test_index_thread_safety():
    """ctypes releases the GIL during native calls: concurrent queries on
    one index must not share mutable scratch (previously SIGABRT)."""
    import threading

    rng = np.random.default_rng(3)
    pts = (rng.random((20_000, 3)) * 10).astype(np.float32)
    ix = HostCellIndex(pts, np.ones(len(pts), bool))
    errs = []

    def worker():
        try:
            for i in range(500):
                ix.radius(pts[i % 200], 1.0)
                ix.knn(pts[i % 200], 8)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs


def test_index_degenerate_clouds_fast_and_exact():
    """Planar / collinear clouds must not explode the cell count (the
    unblended 3D density formula gave billions of cells -> seconds per
    query) and stay exact vs brute force."""
    import time

    rng = np.random.default_rng(4)
    clouds = {
        "collinear": np.stack(
            [np.linspace(0, 100, 1000, dtype=np.float32),
             np.zeros(1000, np.float32), np.zeros(1000, np.float32)],
            axis=1,
        ),
        "planar": np.concatenate(
            [(rng.random((5000, 2)) * 50).astype(np.float32),
             np.zeros((5000, 1), np.float32)], axis=1,
        ),
    }
    for name, pts in clouds.items():
        ix = HostCellIndex(pts, np.ones(len(pts), bool))
        t0 = time.perf_counter()
        for q in pts[:20]:
            rows, dd = ix.knn(q, 5)
            d2 = ((pts.astype(np.float64) - q.astype(np.float64)) ** 2).sum(1)
            ref = np.sort(d2)[:5]
            np.testing.assert_allclose(dd**2, ref, atol=1e-9)
        per_ms = (time.perf_counter() - t0) / 20 * 1e3
        assert per_ms < 50, (name, per_ms)


def test_nonfinite_query_returns_empty_not_hang():
    """A NaN/Inf query must return empty (reference KdTree semantics,
    kdtree.rs:64-80) — the native index's radius-doubling certificate
    would otherwise never terminate (NaN comparisons are all-false)."""
    xyz = _cloud(7, n=2000)
    idx = HostCellIndex(xyz, np.ones(len(xyz), bool))
    for q in ([np.nan, 0, 0], [0, np.inf, 0], [0, 0, -np.inf]):
        rows, dists = idx.knn(q, 5)
        assert len(rows) == 0 and len(dists) == 0
        assert len(idx.radius(q, 1.0)) == 0
    # Non-finite radius likewise returns empty instead of crashing.
    assert len(idx.radius([0.0, 0.0, 0.0], np.nan)) == 0


def test_native_cluster_epilogue_matches_numpy():
    """The C counting-sort epilogue (native.cluster_epilogue) must group
    labels exactly like the numpy argsort epilogue it replaces: clusters
    size-desc with lexicographic (= first member) tiebreak, members
    ascending, min/max size filter inclusive
    (ref: crates/segmentation/src/euclidean_cluster.rs:169-186)."""
    from pointclouds_jax import native as _native

    if not _native.available():
        import pytest

        pytest.skip("native library unavailable")

    rng = np.random.default_rng(11)
    for n, min_size, max_size in [
        (1, 1, 10),
        (50, 1, 50),
        (2000, 2, 300),
        (5000, 1, 4),
        (5000, 3, 5000),
    ]:
        # Random component structure: labels = min member row id, built
        # by assigning rows to random groups.
        groups = rng.integers(0, max(n // 7, 1), size=n)
        labels = np.empty(n, np.int32)
        first = {}
        for i, g in enumerate(groups):
            first.setdefault(int(g), i)
            labels[i] = first[int(g)]

        res = _native.cluster_epilogue(labels, min_size, max_size)
        assert res is not None
        order, starts = res
        native_clusters = [
            order[s:e].tolist() for s, e in zip(starts[:-1], starts[1:])
        ]

        order_np = np.argsort(labels, kind="stable")
        sl = labels[order_np]
        bounds = np.nonzero(np.concatenate([[True], sl[1:] != sl[:-1]]))[0]
        ends = np.concatenate([bounds[1:], [n]])
        expect = []
        for s, e in zip(bounds, ends):
            if min_size <= e - s <= max_size:
                expect.append(order_np[s:e].tolist())
        expect.sort(key=lambda c: (-len(c), c))

        assert native_clusters == expect, (n, min_size, max_size)
