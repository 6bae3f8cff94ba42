"""Cell-centric engine differential tests vs numpy brute force."""

import numpy as np
import jax.numpy as jnp

import pointclouds_jax  # noqa: F401
from pointclouds_jax.core.cloud import make_cloud_arrays
from pointclouds_jax.spatial.cellgrid import (
    build_cellgrid,
    cell_propagate_labels,
    cell_radius_neighbor_blocks,
    cell_sor_mean_dists,
)


def _grid(data, cell, m=16, cap=4096):
    arrs = make_cloud_arrays(data)
    return (
        build_cellgrid(
            arrs.xyz, arrs.valid, jnp.float32(cell), m_per_cell=m, cell_cap=cap
        ),
        arrs,
    )


def brute_sor_means(data, k):
    n = len(data)
    finite = np.all(np.isfinite(data), axis=1)
    means = np.full(n, np.inf)
    for i in range(n):
        if not finite[i]:
            continue
        d = np.linalg.norm(data.astype(np.float64) - data[i].astype(np.float64), axis=1)
        d[~finite] = np.inf
        d = np.sort(d)[: k + 1]
        d = d[np.isfinite(d)]
        nd = d[1:] if len(d) > 1 else d
        if len(nd):
            means[i] = nd.mean()
    return means


def test_cellgrid_sor_means_match_bruteforce():
    rng = np.random.default_rng(0)
    data = (rng.random((2000, 3)) * 4).astype(np.float32)
    k = 8
    # generous cell so all kth neighbors are inside one cell width
    grid, arrs = _grid(data, 0.9, m=64)
    assert not bool(grid.overflow), "cap too small for test"
    means, _, certified = cell_sor_mean_dists(grid, k=k)
    assert bool(certified)
    expect = brute_sor_means(data, k)
    np.testing.assert_allclose(
        np.asarray(means)[: len(data)], expect, rtol=1e-4, atol=1e-5
    )


def test_cellgrid_sor_certificate_fails_with_small_cell():
    rng = np.random.default_rng(1)
    data = (rng.random((500, 3)) * 10).astype(np.float32)
    grid, _ = _grid(data, 0.3, m=16)
    _, _, certified = cell_sor_mean_dists(grid, k=10)
    assert not bool(certified)


def test_cellgrid_handles_nonfinite_and_padding():
    data = np.array(
        [[0, 0, 0], [0.1, 0, 0], [np.nan, 1, 1], [5, 5, 5]], dtype=np.float32
    )
    grid, arrs = _grid(data, 1.0, m=8, cap=4096)
    means, ok, certified = cell_sor_mean_dists(grid, k=2)
    m = np.asarray(means)[:4]
    okh = np.asarray(ok)[:4]
    # With only 3 valid points, every query wants k+1=3 results; the close
    # pair finds only 2 within its neighborhood and the far point only
    # itself, so all are +inf and not-ok (the caller's coarse second pass
    # resolves them); the non-finite point is +inf by contract.
    assert np.isinf(m).all()
    assert not okh[0] and not okh[1] and not okh[3]
    assert not bool(certified)


def test_cellgrid_cluster_labels_match_bruteforce():
    rng = np.random.default_rng(2)
    for trial in range(4):
        n = int(rng.integers(50, 400))
        data = (rng.random((n, 3)) * 3).astype(np.float32)
        r = float(rng.uniform(0.25, 0.7))
        grid, arrs = _grid(data, r * 1.0001 + 1e-5, m=64)
        nb_idx, within = cell_radius_neighbor_blocks(grid, jnp.float32(r))
        labels = np.asarray(cell_propagate_labels(grid, nb_idx, within))[:n]

        d = np.linalg.norm(
            data[:, None].astype(np.float64) - data[None, :].astype(np.float64),
            axis=2,
        )
        adj = d <= r
        # brute-force components
        seen = np.zeros(n, bool)
        comp_id = np.full(n, -1)
        cid = 0
        for i in range(n):
            if seen[i]:
                continue
            stack = [i]
            seen[i] = True
            while stack:
                u = stack.pop()
                comp_id[u] = cid
                for v in np.nonzero(adj[u] & ~seen)[0]:
                    seen[v] = True
                    stack.append(v)
            cid += 1
        # same-partition check
        for a in range(n):
            for b in range(a + 1, n):
                assert (labels[a] == labels[b]) == (
                    comp_id[a] == comp_id[b]
                ), (trial, a, b)


def test_cellgrid_huge_extent_sets_table_overflow():
    data = np.array([[0, 0, 0], [5000.0, 5000.0, 5000.0]], dtype=np.float32)
    grid, _ = _grid(data, 0.01, m=8)
    assert bool(grid.table_overflow)


def test_cell_graph_cluster_matches_bruteforce():
    from pointclouds_jax.spatial.cellgrid import (
        cell_graph_adjacency,
        cell_graph_labels,
    )

    rng = np.random.default_rng(5)
    for trial in range(4):
        n = int(rng.integers(50, 500))
        data = (rng.random((n, 3)) * 3).astype(np.float32)
        if trial == 3:  # inject non-finite points
            data[0] = [np.nan, 0, 0]
            data[1] = [np.inf, 1, 1]
        r = float(rng.uniform(0.25, 0.7))
        arrs = make_cloud_arrays(data)
        grid = build_cellgrid(
            arrs.xyz, arrs.valid, jnp.float32(r / 2), m_per_cell=32,
            cell_cap=4096, ring=2,
        )
        assert not bool(grid.overflow)
        adj = cell_graph_adjacency(grid, jnp.float32(r))
        labels = np.asarray(cell_graph_labels(grid, adj))[:n]

        finite = np.all(np.isfinite(data), axis=1)
        d = np.linalg.norm(
            data[:, None].astype(np.float64) - data[None, :].astype(np.float64),
            axis=2,
        )
        adj_bf = (d <= r) & finite[:, None] & finite[None, :]
        seen = np.zeros(n, bool)
        comp_id = np.full(n, -1)
        cid = 0
        for i in range(n):
            if seen[i]:
                continue
            stack = [i]; seen[i] = True
            while stack:
                u = stack.pop()
                comp_id[u] = cid
                for v in np.nonzero(adj_bf[u] & ~seen)[0]:
                    seen[v] = True; stack.append(v)
            cid += 1
        for a in range(0, n, 7):
            for b in range(a + 1, n, 3):
                assert (labels[a] == labels[b]) == (comp_id[a] == comp_id[b]), (
                    trial, a, b, r)


def test_cellgrid_sor_with_outliers_matches_f64():
    """Certified cell-centric SOR means equal the f64 oracle on a cloud
    with a NaN row and an isolated far point (whose means stay
    uncertified rather than wrong)."""
    rng = np.random.default_rng(12)
    data = np.vstack([
        (rng.random((800, 3)) * 4).astype(np.float32),
        np.array([[np.nan, 0, 0], [50, 50, 50]], dtype=np.float32),
    ])
    arrs = make_cloud_arrays(data)
    grid = build_cellgrid(
        arrs.xyz, arrs.valid, jnp.float32(0.8), m_per_cell=32, cell_cap=2048
    )
    means, ok, cert = cell_sor_mean_dists(grid, k=7, chunk=256)
    means = np.asarray(means)[: len(data)]
    ok = np.asarray(ok)[: len(data)]
    expect = brute_sor_means(data, 7)
    assert ok[:800].mean() > 0.95
    assert not ok[800] and not bool(cert)  # NaN row / far point flagged
    np.testing.assert_allclose(means[ok], expect[ok], rtol=1e-5, atol=1e-6)


def test_point_sor_matches_cell_sor():
    from pointclouds_jax.spatial.cellgrid import point_sor_mean_dists

    rng = np.random.default_rng(21)
    data = np.vstack([
        (rng.random((1500, 3)) * 5).astype(np.float32),
        np.array([[np.nan, 0, 0], [80, 80, 80]], dtype=np.float32),
    ])
    arrs = make_cloud_arrays(data)
    grid = build_cellgrid(
        arrs.xyz, arrs.valid, jnp.float32(0.9), m_per_cell=32, cell_cap=2048
    )
    m_c, ok_c, cert_c = cell_sor_mean_dists(grid, k=9, chunk=256)
    m_p, ok_p, cert_p = point_sor_mean_dists(
        grid, arrs.xyz, arrs.valid, k=9, qchunk=512
    )
    np.testing.assert_allclose(
        np.asarray(m_c), np.asarray(m_p), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_array_equal(np.asarray(ok_c), np.asarray(ok_p))
    assert bool(cert_c) == bool(cert_p)


def test_point_knn_matches_bruteforce():
    from pointclouds_jax.spatial.cellgrid import point_knn

    rng = np.random.default_rng(33)
    pts = (rng.random((3000, 3)) * 6).astype(np.float32)
    queries = np.vstack([
        (rng.random((500, 3)) * 6).astype(np.float32),  # cross-cloud
        pts[:100],                                       # same-cloud
        np.array([[np.nan, 0, 0], [20, 20, 20]], dtype=np.float32),
    ])
    k = 7
    parrs = make_cloud_arrays(pts)
    qarrs = make_cloud_arrays(queries)
    grid = build_cellgrid(
        parrs.xyz, parrs.valid, jnp.float32(0.8), m_per_cell=32, cell_cap=4096
    )
    dists, idx, nvalid, ok = point_knn(grid, qarrs.xyz, qarrs.valid, k=k)
    d = np.asarray(dists)[: len(queries)]
    nv = np.asarray(nvalid)[: len(queries)]

    expect = np.sort(
        np.linalg.norm(
            pts[None].astype(np.float64) - queries[:, None].astype(np.float64),
            axis=2,
        ),
        axis=1,
    )[:, :k]
    for qi in range(len(queries)):
        if not np.all(np.isfinite(queries[qi])):
            assert not nv[qi].any()
            continue
        if queries[qi][0] == 20.0:  # far outside the grid: no candidates
            assert not nv[qi].any()
            continue
        got = d[qi][nv[qi]]
        np.testing.assert_allclose(got, expect[qi][: len(got)], atol=1e-4)


def test_point_radius_count_matches_bruteforce():
    from pointclouds_jax.spatial.cellgrid import point_radius_count

    rng = np.random.default_rng(34)
    pts = (rng.random((2000, 3)) * 4).astype(np.float32)
    queries = (rng.random((300, 3)) * 4).astype(np.float32)
    r = 0.5
    parrs = make_cloud_arrays(pts)
    qarrs = make_cloud_arrays(queries)
    grid = build_cellgrid(
        parrs.xyz, parrs.valid, jnp.float32(r * 1.00002), m_per_cell=64,
        cell_cap=4096,
    )
    assert not bool(grid.overflow)
    counts = np.asarray(
        point_radius_count(grid, qarrs.xyz, qarrs.valid, jnp.float32(r))
    )[: len(queries)]
    d = np.linalg.norm(
        pts[None].astype(np.float64) - queries[:, None].astype(np.float64),
        axis=2,
    )
    np.testing.assert_array_equal(counts, (d <= r).sum(axis=1))
