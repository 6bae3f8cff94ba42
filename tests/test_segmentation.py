"""RANSAC + clustering behavior and differential parity
(crates/segmentation/src/{ransac_plane,euclidean_cluster}.rs)."""

import numpy as np
import pytest

import pointclouds_jax as pc


# ── RANSAC ───────────────────────────────────────────────────────────────────


def test_ransac_z_plane():
    rng = np.random.default_rng(0)
    data = np.column_stack(
        [rng.random(100), rng.random(100), np.zeros(100)]
    ).astype(np.float32)
    r = pc.ransac_plane(pc.PointCloud.from_numpy(data), 0.01, 100)
    assert abs(r.normal[2]) > 0.9
    assert len(r.inliers) > 90
    np.testing.assert_allclose(np.linalg.norm(r.normal), 1.0, atol=1e-5)


def test_ransac_three_points_exact_plane():
    data = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=np.float32)
    r = pc.ransac_plane(pc.PointCloud.from_numpy(data), 0.01, 10)
    assert abs(r.normal[2]) > 0.9
    assert len(r.inliers) == 3


def test_ransac_fewer_than_three_points_default_model():
    data = np.array([[0, 0, 0], [1, 0, 0]], dtype=np.float32)
    r = pc.ransac_plane(pc.PointCloud.from_numpy(data), 0.1, 10)
    assert r.normal == [0.0, 0.0, 1.0]
    assert r.d == 0.0
    assert r.inliers == []


def test_ransac_seeded_deterministic():
    rng = np.random.default_rng(1)
    plane = np.column_stack(
        [rng.random(200) * 10, rng.random(200) * 10, rng.normal(0, 0.01, 200)]
    )
    noise = rng.uniform(-5, 5, (50, 3))
    data = np.vstack([plane, noise]).astype(np.float32)
    c = pc.PointCloud.from_numpy(data)
    r1 = pc.ransac_plane_seeded(c, 0.05, 200, seed=1234)
    r2 = pc.ransac_plane_seeded(c, 0.05, 200, seed=1234)
    assert r1.normal == r2.normal
    assert r1.inliers == r2.inliers


def test_ransac_finds_dominant_plane_with_outliers():
    rng = np.random.default_rng(2)
    plane = np.column_stack(
        [rng.random(500) * 10, rng.random(500) * 10, rng.normal(1.0, 0.02, 500)]
    )
    noise = rng.uniform(0, 10, (100, 3))
    data = np.vstack([plane, noise]).astype(np.float32)
    r = pc.ransac_plane_seeded(pc.PointCloud.from_numpy(data), 0.06, 300, seed=7)
    assert abs(r.normal[2]) > 0.99
    # d should place the plane near z=1: n.x + d = 0 -> d ~ -normal_z * 1
    assert abs(abs(r.d) - 1.0) < 0.1
    assert len(r.inliers) >= 480


def test_ransac_inliers_within_threshold():
    rng = np.random.default_rng(3)
    data = (rng.random((300, 3)) * 4).astype(np.float32)
    t = 0.25
    r = pc.ransac_plane_seeded(pc.PointCloud.from_numpy(data), t, 100, seed=5)
    n = np.array(r.normal)
    for i in r.inliers:
        assert abs(np.dot(n, data[i]) + r.d) <= t + 1e-5


def test_ransac_inlier_indices_sorted():
    rng = np.random.default_rng(4)
    data = (rng.random((100, 3)) * [5, 5, 0.01]).astype(np.float32)
    r = pc.ransac_plane_seeded(pc.PointCloud.from_numpy(data), 0.1, 50, seed=9)
    assert r.inliers == sorted(r.inliers)


# ── Euclidean clustering ─────────────────────────────────────────────────────


def brute_cluster(data, r, min_size, max_size):
    """O(n^2) BFS connected components: the differential oracle
    (tests/cluster_differential.rs:13-82 pattern)."""
    n = len(data)
    finite = np.all(np.isfinite(data), axis=1)
    d = np.linalg.norm(
        data[:, None, :].astype(np.float64) - data[None, :, :].astype(np.float64),
        axis=2,
    )
    adj = (d <= r) & finite[:, None] & finite[None, :]
    seen = np.zeros(n, bool)
    comps = []
    for i in range(n):
        if seen[i]:
            continue
        stack, comp = [i], []
        seen[i] = True
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in np.nonzero(adj[u] & ~seen)[0]:
                seen[v] = True
                stack.append(v)
        comps.append(sorted(comp))
    out = [c for c in comps if min_size <= len(c) <= max_size]
    out.sort(key=lambda c: (-len(c), c))
    return out


def test_cluster_two_far_groups():
    rng = np.random.default_rng(5)
    c1 = rng.random((20, 3)).astype(np.float32) * 0.1
    c2 = rng.random((20, 3)).astype(np.float32) * 0.1 + 10.0
    clusters = pc.euclidean_cluster(
        pc.PointCloud.from_numpy(np.vstack([c1, c2])), 0.5, 5, 100
    )
    assert len(clusters) == 2
    assert sorted(len(c) for c in clusters) == [20, 20]


def test_cluster_differential_small_random():
    rng = np.random.default_rng(6)
    for trial in range(8):
        n = int(rng.integers(5, 120))
        data = (rng.random((n, 3)) * 3).astype(np.float32)
        r = float(rng.uniform(0.2, 1.0))
        expect = brute_cluster(data, r, 1, 10**9)
        got = pc.euclidean_cluster(pc.PointCloud.from_numpy(data), r, 1, 10**9)
        assert got == expect, f"trial {trial}: n={n} r={r}"


def test_cluster_differential_medium():
    rng = np.random.default_rng(7)
    data = (rng.random((800, 3)) * 6).astype(np.float32)
    r = 0.35
    expect = brute_cluster(data, r, 2, 10**9)
    got = pc.euclidean_cluster(pc.PointCloud.from_numpy(data), r, 2, 10**9)
    assert got == expect


def test_cluster_threshold_inclusive():
    # d == threshold connects (cluster_differential.rs:151-163)
    data = np.array([[0, 0, 0], [1.0, 0, 0]], dtype=np.float32)
    got = pc.euclidean_cluster(pc.PointCloud.from_numpy(data), 1.0, 1, 10)
    assert len(got) == 1 and got[0] == [0, 1]
    # just beyond: separate
    data2 = np.array([[0, 0, 0], [1.0001, 0, 0]], dtype=np.float32)
    got2 = pc.euclidean_cluster(pc.PointCloud.from_numpy(data2), 1.0, 1, 10)
    assert len(got2) == 2


def test_cluster_cell_boundary_straddle():
    # Points on opposite sides of a grid-cell boundary, within r
    data = np.array(
        [[0.999, 0, 0], [1.001, 0, 0], [5, 5, 5]], dtype=np.float32
    )
    got = pc.euclidean_cluster(pc.PointCloud.from_numpy(data), 0.5, 1, 10)
    assert got[0] == [0, 1]


def test_cluster_nonfinite_points_are_singletons():
    data = np.array(
        [[0, 0, 0], [0.1, 0, 0], [np.nan, 0, 0], [np.inf, 0, 0]],
        dtype=np.float32,
    )
    got = pc.euclidean_cluster(pc.PointCloud.from_numpy(data), 1.0, 1, 10)
    # finite pair clusters; NaN and Inf are singletons
    assert got[0] == [0, 1]
    assert [2] in got and [3] in got


def test_cluster_size_filters():
    rng = np.random.default_rng(8)
    c1 = rng.random((30, 3)).astype(np.float32) * 0.1
    c2 = rng.random((5, 3)).astype(np.float32) * 0.1 + 10
    data = np.vstack([c1, c2])
    got = pc.euclidean_cluster(pc.PointCloud.from_numpy(data), 0.5, 10, 100)
    assert len(got) == 1 and len(got[0]) == 30
    got2 = pc.euclidean_cluster(pc.PointCloud.from_numpy(data), 0.5, 1, 10)
    assert len(got2) == 1 and len(got2[0]) == 5


def test_cluster_guards():
    data = np.array([[0, 0, 0]], dtype=np.float32)
    c = pc.PointCloud.from_numpy(data)
    assert pc.euclidean_cluster(pc.PointCloud(), 1.0, 1, 10) == []
    assert pc.euclidean_cluster(c, 0.0, 1, 10) == []
    assert pc.euclidean_cluster(c, -1.0, 1, 10) == []
    assert pc.euclidean_cluster(c, 1.0, 0, 10) == []
    # single point below min_size
    assert pc.euclidean_cluster(c, 1.0, 2, 100) == []


def test_cluster_canonical_order():
    # clusters sorted size-desc, ties by first index; indices ascending
    data = np.array(
        [[0, 0, 0], [10, 0, 0], [10.1, 0, 0], [20, 0, 0], [20.1, 0, 0]],
        dtype=np.float32,
    )
    got = pc.euclidean_cluster(pc.PointCloud.from_numpy(data), 0.5, 1, 10)
    assert got == [[1, 2], [3, 4], [0]]


def test_cluster_shuffle_metamorphic():
    """Co-membership is invariant under point order shuffling
    (cluster_differential.rs:225-280)."""
    rng = np.random.default_rng(9)
    data = (rng.random((100, 3)) * 3).astype(np.float32)
    r = 0.4
    base = pc.euclidean_cluster(pc.PointCloud.from_numpy(data), r, 1, 10**9)
    perm = rng.permutation(100)
    shuf = data[perm]
    got = pc.euclidean_cluster(pc.PointCloud.from_numpy(shuf), r, 1, 10**9)

    def canon(clusters, mapping=None):
        out = set()
        for cl in clusters:
            ids = tuple(sorted(mapping[i] if mapping is not None else i for i in cl))
            out.add(ids)
        return out

    inv = np.argsort(perm)  # shuffled index -> original index
    assert canon(base) == canon(got, mapping=perm)


def test_cluster_translation_metamorphic():
    rng = np.random.default_rng(10)
    data = (rng.random((150, 3)) * 3).astype(np.float32)
    r = 0.4
    base = pc.euclidean_cluster(pc.PointCloud.from_numpy(data), r, 1, 10**9)
    moved = data + np.array([100.0, -50.0, 25.0], np.float32)
    got = pc.euclidean_cluster(pc.PointCloud.from_numpy(moved), r, 1, 10**9)
    assert base == got


def test_cluster_determinism_repeated():
    rng = np.random.default_rng(11)
    data = (rng.random((500, 3)) * 4).astype(np.float32)
    c = pc.PointCloud.from_numpy(data)
    first = pc.euclidean_cluster(c, 0.3, 1, 10**9)
    for _ in range(5):
        assert pc.euclidean_cluster(c, 0.3, 1, 10**9) == first


def test_cluster_long_chain():
    # Worst case for label propagation: one long chain
    n = 300
    data = np.column_stack(
        [np.arange(n) * 0.5, np.zeros(n), np.zeros(n)]
    ).astype(np.float32)
    got = pc.euclidean_cluster(pc.PointCloud.from_numpy(data), 0.5, 1, 10**9)
    assert len(got) == 1 and len(got[0]) == n


def test_cluster_pathological_density_exact():
    """A single cell holding more points than any candidate cap still
    clusters exactly: cluster_labels and radius_neighbors both bail, and
    the uncapped brute-force propagation takes over."""
    rng = np.random.default_rng(77)
    dense = rng.random((2000, 3)).astype(np.float32) * 0.05  # one tiny ball
    far = rng.random((50, 3)).astype(np.float32) * 0.05 + 100.0
    data = np.vstack([dense, far])
    clusters = pc.euclidean_cluster(pc.PointCloud.from_numpy(data), 1.0, 5, 5000)
    expect = brute_cluster(data, 1.0, 5, 5000)
    assert [len(c) for c in clusters] == [len(c) for c in expect]
    assert clusters == expect


def test_ransac_tournament_matches_full_scoring():
    """score_subsample (tournament scoring: subsample + top-m full-cloud
    rescore) must pick the same plane as full scoring on a scene with a
    clear dominant plane, across seeds — and the degenerate/empty edge
    cases must keep their defaults."""
    import jax.numpy as jnp

    from pointclouds_jax.core.cloud import make_cloud_arrays
    from pointclouds_jax.ops.segmentation import ransac_plane_masked

    rng = np.random.default_rng(4)
    data = np.vstack([
        (rng.random((30_000, 3)) * [20, 20, 0.06]).astype(np.float32),
        (rng.random((8_000, 3)) * 20).astype(np.float32),
    ])
    arrs = make_cloud_arrays(data)
    for seed in (0, 7, 1234):
        full = ransac_plane_masked(
            arrs.xyz, arrs.valid, jnp.float32(0.05), seed, 300
        )
        tour = ransac_plane_masked(
            arrs.xyz, arrs.valid, jnp.float32(0.05), seed, 300,
            score_subsample=2048,
        )
        np.testing.assert_allclose(
            np.asarray(full[0]), np.asarray(tour[0]), atol=1e-6
        )
        np.testing.assert_allclose(
            float(full[1]), float(tour[1]), atol=1e-6
        )
        np.testing.assert_array_equal(
            np.asarray(full[2]), np.asarray(tour[2])
        )

    # Subsample larger than the cloud: duplicates masked, still correct.
    small = make_cloud_arrays(data[:500])
    f = ransac_plane_masked(small.xyz, small.valid, jnp.float32(0.05), 3, 64)
    t = ransac_plane_masked(
        small.xyz, small.valid, jnp.float32(0.05), 3, 64,
        score_subsample=2048,
    )
    np.testing.assert_array_equal(np.asarray(f[2]), np.asarray(t[2]))

    # All-degenerate samples (a single repeated point): default model.
    one = make_cloud_arrays(np.zeros((3, 3), np.float32))
    nrm, d, mask = ransac_plane_masked(
        one.xyz, one.valid, jnp.float32(0.05), 0, 32, score_subsample=256
    )
    assert np.asarray(mask).sum() == 0 or abs(float(d)) < 1e-6


def test_ransac_full_scoring_matches_f64_counts():
    """Full batched scoring (no subsample) must select the hypothesis with
    the most f64-counted inliers, and its inlier mask must be the f64
    inlier set of that plane (up to points within f32 rounding of the
    threshold)."""
    import jax.numpy as jnp
    from pointclouds_jax.core.cloud import make_cloud_arrays
    from pointclouds_jax.ops.segmentation import ransac_plane_masked

    rng = np.random.default_rng(17)
    data = np.vstack([
        (rng.random((4_000, 3)) * [10, 10, 0.02]).astype(np.float32),
        (rng.random((1_200, 3)) * 10).astype(np.float32),
    ])
    arrs = make_cloud_arrays(data)
    thr = 0.05
    for seed in (0, 5):
        normal, d, deg, use_pt, cnt, _ = _hypotheses_for(arrs, seed, 300, thr)
        n64 = np.asarray(normal, np.float64)
        d64 = np.asarray(d, np.float64)
        dist = np.abs(data.astype(np.float64) @ n64.T + d64[None, :])
        lo = (dist <= thr * (1 - 1e-5)).sum(0)
        hi = (dist <= thr * (1 + 1e-5)).sum(0)
        lo[np.asarray(deg)] = hi[np.asarray(deg)] = -1
        best_n, best_d, mask = ransac_plane_masked(
            arrs.xyz, arrs.valid, jnp.float32(thr), seed, 300,
            assume_compact=True,
        )
        win = int(np.argmax(np.all(
            np.isclose(n64, np.asarray(best_n)[None], atol=0), axis=1
        )))
        # The winner's count is the maximum, up to threshold-rounding.
        assert hi[win] >= lo.max()
        mask = np.asarray(mask)[: len(data)]
        dw = dist[:, win]
        sure_in, sure_out = dw <= thr * (1 - 1e-5), dw > thr * (1 + 1e-5)
        assert mask[sure_in].all() and not mask[sure_out].any()


def _hypotheses_for(arrs, seed, iterations, threshold):
    """Replicate ransac_plane_masked's hypothesis generation (sampling,
    plane fits, degeneracy) so tests can drive the sequential scan and a
    python oracle from identical inputs."""
    import jax
    import jax.numpy as jnp

    from pointclouds_jax.core.cloud import compaction_order
    from pointclouds_jax.ops import segmentation as S

    finite = jnp.all(jnp.isfinite(arrs.xyz), axis=-1)
    cnt = jnp.sum(arrs.valid.astype(jnp.int32))
    samples = S._sample_three_distinct(
        jax.random.PRNGKey(seed), iterations, cnt
    )
    order = compaction_order(arrs.valid)
    idx = jnp.take(order, samples.reshape(-1)).reshape(samples.shape)
    p = jnp.take(arrs.xyz, idx.reshape(-1), axis=0).reshape(iterations, 3, 3)
    v1, v2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    nrm = jnp.cross(v1, v2)
    ln = jnp.linalg.norm(nrm, axis=1)
    deg = ln < 1e-10
    normal = nrm / jnp.where(deg, 1.0, ln)[:, None]
    d = -jnp.sum(normal * p[:, 0], axis=1)
    use_pt = jnp.logical_and(arrs.valid, finite)
    dist = jnp.abs(
        jax.lax.dot(arrs.xyz, normal.T, precision=jax.lax.Precision.HIGHEST)
        + d[None, :]
    )
    counts = np.asarray(
        jnp.sum(
            jnp.logical_and(use_pt[:, None], dist <= threshold), axis=0,
            dtype=jnp.int32,
        )
    )
    counts = np.where(np.asarray(deg), -1, counts)
    return normal, d, deg, use_pt, int(cnt), counts


def _sequential_oracle(counts, cnt):
    """The reference's sequential loop with adaptive early termination
    (crates/segmentation/src/ransac_plane.rs:93-121), replayed in python
    over per-hypothesis inlier counts."""
    import math

    best, bi, ne = 0, 0, 0
    for i, c in enumerate(counts):
        ne += 1
        if c > best:
            best, bi = int(c), i
            w = best / cnt
            if w > 0.5:
                needed = math.log(0.001) / math.log(1 - w**3)
                if i > needed:
                    break
    return bi, best, ne


def test_ransac_adaptive_scan_matches_sequential_oracle():
    """The chunked lax.while_loop scan must reproduce the reference's
    sequential adaptive-termination semantics exactly: same winner, same
    best count, same number of evaluated iterations — and it must
    actually terminate early on a noisy high-inlier scene."""
    import jax.numpy as jnp

    from pointclouds_jax.core.cloud import make_cloud_arrays
    from pointclouds_jax.ops import segmentation as S

    rng = np.random.default_rng(1)
    base = rng.random((4000, 3)).astype(np.float32) * [10, 10, 0]
    base[:, 2] = rng.normal(0, 0.03, 4000).astype(np.float32)
    out = (rng.random((600, 3)) * [10, 10, 4] + [0, 0, 0.5]).astype(
        np.float32
    )
    arrs = make_cloud_arrays(np.vstack([base, out]))
    iters = 500
    terminated_early = 0
    for seed in (0, 3, 7, 11):
        normal, d, deg, use_pt, cnt, counts = _hypotheses_for(
            arrs, seed, iters, 0.05
        )
        obi, obest, one = _sequential_oracle(counts, cnt)
        sbi, sbc, sne = S._ransac_sequential_scan(
            arrs.xyz, use_pt, normal, d, deg, jnp.float32(0.05),
            jnp.int32(cnt), iters,
        )
        assert (int(sbi), int(sbc), int(sne)) == (obi, obest, one), seed
        terminated_early += int(one < iters)
        # The winning model must be the oracle-selected hypothesis.
        adap = S.ransac_plane_masked(
            arrs.xyz, arrs.valid, jnp.float32(0.05), seed, iters,
            adaptive=True,
        )
        np.testing.assert_allclose(
            np.asarray(adap[0]), np.asarray(normal[obi]), atol=1e-7
        )
    assert terminated_early >= 3  # the feature actually fires


def test_ransac_adaptive_dispatch_full_scoring_on_large_clouds():
    """At >= 10_000 valid points and >= 16 iterations the reference uses
    its parallel (score-everything) path — adaptive=True must then be
    bit-identical to the default batched scoring."""
    import jax.numpy as jnp

    from pointclouds_jax.core.cloud import make_cloud_arrays
    from pointclouds_jax.ops.segmentation import ransac_plane_masked

    rng = np.random.default_rng(5)
    data = np.vstack([
        (rng.random((11_000, 3)) * [20, 20, 0.06]).astype(np.float32),
        (rng.random((2_000, 3)) * 20).astype(np.float32),
    ])
    arrs = make_cloud_arrays(data)
    for seed in (0, 9):
        full = ransac_plane_masked(
            arrs.xyz, arrs.valid, jnp.float32(0.05), seed, 200
        )
        adap = ransac_plane_masked(
            arrs.xyz, arrs.valid, jnp.float32(0.05), seed, 200,
            adaptive=True,
        )
        np.testing.assert_array_equal(np.asarray(full[0]), np.asarray(adap[0]))
        np.testing.assert_array_equal(np.asarray(full[2]), np.asarray(adap[2]))
