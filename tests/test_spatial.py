"""Differential tests for the grid-hash neighbor engine vs numpy brute force
(the cluster_differential.rs pattern from the reference test strategy,
SURVEY.md section 4.3)."""

import numpy as np
import jax.numpy as jnp
import pytest

import pointclouds_jax  # noqa: F401  (enables x64 for int64 cell keys)
from pointclouds_jax.core.cloud import make_cloud_arrays
from pointclouds_jax.spatial import engine
from pointclouds_jax.spatial.grid import build_grid
from pointclouds_jax.spatial.knn import grid_knn, bruteforce_knn


def _cloud(data):
    arrs = make_cloud_arrays(data)
    return arrs.xyz, arrs.valid


def np_knn(data, q, k):
    d = np.linalg.norm(data[None, :, :] - q[:, None, :], axis=2)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, axis=1), idx


DISTRIBUTIONS = {
    "uniform": lambda rng, n: rng.random((n, 3)) * 10,
    "clustered": lambda rng, n: np.vstack(
        [
            rng.normal(c, 0.2, (n // 4, 3))
            for c in ([0, 0, 0], [5, 5, 5], [9, 1, 3], [2, 8, 6])
        ]
    ),
    "planar": lambda rng, n: np.column_stack(
        [rng.random(n) * 20, rng.random(n) * 20, rng.normal(0, 0.05, n)]
    ),
    "anisotropic": lambda rng, n: rng.random((n, 3)) * [100, 1, 0.1],
}


@pytest.mark.parametrize("dist", list(DISTRIBUTIONS))
def test_engine_knn_matches_bruteforce(dist):
    rng = np.random.default_rng(hash(dist) % 2**31)
    n, k = 4096, 11  # above BRUTE_THRESHOLD so the grid path is exercised
    data = DISTRIBUTIONS[dist](rng, n).astype(np.float32)
    xyz, valid = _cloud(data)
    dists, idx, nvalid = engine.knn(xyz, valid, xyz, valid, k)
    dists = np.asarray(dists)[: len(data)]
    nvalid = np.asarray(nvalid)[: len(data)]
    assert nvalid.all()
    expect_d, _ = np_knn(data.astype(np.float64), data.astype(np.float64), k)
    np.testing.assert_allclose(dists, expect_d, atol=1e-4)


def test_grid_knn_flags_inexact_when_cell_too_small():
    rng = np.random.default_rng(42)
    data = (rng.random((4000, 3)) * 10).astype(np.float32)
    xyz, valid = _cloud(data)
    # Deliberately tiny cell: most queries can't find k=10 within 27 cells.
    grid = build_grid(xyz, valid, 0.05)
    _, _, _, overflow, insufficient = grid_knn(grid, xyz, valid, 10, 16)
    assert bool(insufficient)


def test_bruteforce_knn_self_query_returns_self_first():
    data = np.array([[0, 0, 0], [1, 0, 0], [5, 5, 5]], dtype=np.float32)
    xyz, valid = _cloud(data)
    dists, idx, nvalid = bruteforce_knn(xyz, valid, xyz, valid, 2)
    d = np.asarray(dists)[:3]
    assert np.allclose(d[:, 0], 0.0)
    assert np.asarray(idx)[0, 0] == 0
    assert np.asarray(idx)[0, 1] == 1


def test_knn_nonfinite_query_gets_no_results():
    data = np.array(
        [[np.nan, 0, 0], [1, 0, 0], [2, 0, 0]], dtype=np.float32
    )
    xyz, valid = _cloud(data)
    dists, idx, nvalid = bruteforce_knn(xyz, valid, xyz, valid, 2)
    nv = np.asarray(nvalid)
    assert not nv[0].any()  # NaN query -> empty (kdtree.rs:65-67)
    assert nv[1].all()


def test_knn_k_greater_than_n_returns_all():
    data = np.random.rand(5, 3).astype(np.float32)
    xyz, valid = _cloud(data)
    dists, idx, nvalid = engine.knn(xyz, valid, xyz, valid, 50)
    nv = np.asarray(nvalid)[:5]
    assert nv.sum() == 5 * 5


def test_radius_count_differential():
    rng = np.random.default_rng(9)
    data = (rng.random((3000, 3)) * 5).astype(np.float32)
    r = 0.35
    xyz, valid = _cloud(data)
    counts = np.asarray(engine.radius_count(xyz, valid, xyz, valid, r))[: len(data)]
    d = np.linalg.norm(
        data[None, :, :].astype(np.float64) - data[:, None, :].astype(np.float64),
        axis=2,
    )
    expect = (d <= r).sum(axis=1)
    np.testing.assert_array_equal(counts, expect)


def test_radius_boundary_inclusive():
    data = np.array([[0, 0, 0], [1.0, 0, 0], [2.0001, 0, 0]], dtype=np.float32)
    xyz, valid = _cloud(data)
    counts = np.asarray(engine.radius_count(xyz, valid, xyz, valid, 1.0))[:3]
    # exactly at distance 1.0 counts (inclusive, kdtree.rs:118-127)
    np.testing.assert_array_equal(counts, [2, 2, 1])


def test_radius_neighbors_symmetric_edges():
    rng = np.random.default_rng(10)
    data = (rng.random((500, 3)) * 2).astype(np.float32)
    r = 0.3
    xyz, valid = _cloud(data)
    idx, within = engine.radius_neighbors(xyz, valid, r)
    idx = np.asarray(idx)
    within = np.asarray(within)
    n = len(data)
    adj = np.zeros((n, n), bool)
    for i in range(n):
        for j, w in zip(idx[i], within[i]):
            if w and i < n and j < n:
                adj[i, j] = True
    d = np.linalg.norm(data[:, None] - data[None, :], axis=2)
    expect = d <= r
    np.testing.assert_array_equal(adj[:n, :n], expect)


def test_engine_knn_with_huge_coordinates():
    # Cell-coordinate clamping must not break exactness (grid.py clamp note)
    rng = np.random.default_rng(11)
    data = (rng.random((3000, 3)) * 0.01 + 1e6).astype(np.float32)
    xyz, valid = _cloud(data)
    dists, idx, nvalid = engine.knn(xyz, valid, xyz, valid, 4)
    expect_d, _ = np_knn(data.astype(np.float64), data.astype(np.float64), 4)
    np.testing.assert_allclose(
        np.asarray(dists)[: len(data)], expect_d, atol=2e-2
    )  # f32 catastrophic cancellation at 1e6 dominates tolerance


# ── Single-query public API: radius_search / radius_search_unsorted /
#    knn_indices parity (ref: crates/spatial/src/kdtree.rs:82-163 tests
#    :186-286) ──────────────────────────────────────────────────────────────


def _pc(data):
    import pointclouds_jax as pc

    return pc.PointCloud.from_numpy(np.ascontiguousarray(data, np.float32))


def test_radius_search_finds_points_sorted():
    import pointclouds_jax as pc

    cloud = _pc(np.array([[0, 0, 0], [0.5, 0, 0], [2, 0, 0]], np.float32))
    idx = pc.radius_search(cloud, [0.0, 0.0, 0.0], 0.75)
    assert idx == [0, 1]
    assert idx == sorted(idx)


def test_radius_search_exact_boundary_inclusive():
    import pointclouds_jax as pc

    cloud = _pc(np.array([[1, 0, 0], [5, 0, 0]], np.float32))
    assert pc.radius_search(cloud, [0.0, 0.0, 0.0], 1.0) == [0]


def test_radius_search_edge_cases():
    import pointclouds_jax as pc

    empty = pc.PointCloud()
    assert pc.radius_search(empty, [0, 0, 0], 10.0) == []
    one = _pc(np.zeros((1, 3), np.float32))
    assert pc.radius_search(one, [0, 0, 0], -1.0) == []
    assert pc.radius_search(one, [0, 0, 0], float("inf")) == []
    assert pc.radius_search(one, [float("nan"), 0, 0], 1.0) == []


def test_radius_search_unsorted_same_set():
    import pointclouds_jax as pc

    rng = np.random.default_rng(3)
    data = rng.random((400, 3)).astype(np.float32)
    cloud = _pc(data)
    q = [0.5, 0.5, 0.5]
    s = pc.radius_search(cloud, q, 0.3)
    u = pc.radius_search_unsorted(cloud, q, 0.3)
    assert sorted(u) == s
    d = np.linalg.norm(data - np.asarray(q, np.float32), axis=1)
    np.testing.assert_array_equal(np.asarray(s), np.nonzero(d <= 0.3)[0])


def test_knn_indices_matches_knn():
    import pointclouds_jax as pc

    rng = np.random.default_rng(4)
    data = rng.random((300, 3)).astype(np.float32)
    cloud = _pc(data)
    q = np.array([0.2, 0.2, 0.2], np.float32)
    idx = pc.knn_indices(cloud, q, 5)
    d = np.linalg.norm(data - q, axis=1)
    expect = np.argsort(d, kind="stable")[:5]
    assert idx == [int(i) for i in expect]
    # edge cases (ref kdtree.rs:88-90)
    assert pc.knn_indices(cloud, q, 0) == []
    assert pc.knn_indices(pc.PointCloud(), q, 3) == []
    assert pc.knn_indices(cloud, [np.nan, 0, 0], 3) == []
    assert len(pc.knn_indices(_pc(data[:3]), q, 100)) == 3


def test_api_knn_self_query_fast_path_matches_cross_cloud():
    """pc.knn(cloud, cloud_points, k) takes the fused same-cloud sweep when
    the query batch IS the cloud's point set; results must be identical to
    the generic cross-cloud path (here: brute oracle)."""
    import pointclouds_jax as pc

    rng = np.random.default_rng(77)
    data = (rng.random((4500, 3)) * 10).astype(np.float32)  # > 128 batch
    cloud = _pc(data)
    k = 8
    idx, dists = pc.knn(cloud, data, k)
    assert idx.shape == (4500, k) and dists.shape == (4500, k)
    expect_d, expect_i = np_knn(
        data.astype(np.float64), data.astype(np.float64), k
    )
    np.testing.assert_allclose(dists, expect_d, atol=1e-4)
    # self is always the nearest neighbor at distance 0
    assert (idx[:, 0] == np.arange(4500)).all()
    # a perturbed batch (NOT the cloud's points) must still be exact
    q2 = data[:200] + np.float32(0.01)
    idx2, dists2 = pc.knn(cloud, q2, k)
    e2_d, _ = np_knn(data.astype(np.float64), q2.astype(np.float64), k)
    np.testing.assert_allclose(dists2, e2_d, atol=1e-4)
