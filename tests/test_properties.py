"""Property-based tests (hypothesis): the analogue of the reference's
proptest suites (SURVEY.md section 4.2) — roundtrip, monotonicity, and
invariant properties over randomized inputs."""

import numpy as np
from hypothesis import given, settings, strategies as st

import pointclouds_jax as pc

SETTINGS = dict(max_examples=15, deadline=None)


def clouds(min_n=0, max_n=120):
    return st.integers(min_n, max_n).flatmap(
        lambda n: st.integers(0, 2**31 - 1).map(
            lambda seed: (
                np.random.default_rng(seed)
                .uniform(-8, 8, (n, 3))
                .astype(np.float32)
            )
        )
    )


@given(clouds(min_n=1))
@settings(**SETTINGS)
def test_roundtrip_interleave(data):
    # cloud.rs proptest: from_array/to_array roundtrip (cloud.rs:326-358)
    c = pc.PointCloud.from_numpy(data)
    np.testing.assert_array_equal(c.to_numpy(), data)


@given(clouds(min_n=1), st.floats(0.05, 5.0))
@settings(**SETTINGS)
def test_voxel_never_increases_count(data, voxel):
    # voxel_downsample.rs:101-115 property
    c = pc.PointCloud.from_numpy(data)
    assert pc.voxel_downsample(c, voxel).len() <= c.len()


@given(clouds(min_n=2), st.integers(1, 12), st.floats(0.0, 3.0))
@settings(**SETTINGS)
def test_sor_never_increases_count(data, k, std_mul):
    # statistical_outlier.rs:148-166 property
    c = pc.PointCloud.from_numpy(data)
    out = pc.statistical_outlier_removal(c, k, std_mul)
    assert out.len() <= c.len()


@given(clouds(min_n=1), st.floats(0.05, 4.0), st.integers(0, 6))
@settings(**SETTINGS)
def test_ror_never_increases_count(data, radius, min_n):
    # radius_outlier.rs:64-82 property
    c = pc.PointCloud.from_numpy(data)
    assert pc.radius_outlier_removal(c, radius, min_n).len() <= c.len()


@given(clouds(min_n=1), st.floats(-5, 0), st.floats(0, 5))
@settings(**SETTINGS)
def test_passthrough_keeps_only_in_range(data, lo, hi):
    # passthrough.rs:87-108 property
    c = pc.PointCloud.from_numpy(data)
    out = pc.passthrough_filter(c, "y", lo, hi).to_numpy()
    if len(out):
        assert (out[:, 1] >= lo).all() and (out[:, 1] <= hi).all()


@given(clouds(min_n=3), st.integers(2, 10))
@settings(**SETTINGS)
def test_normals_unit_length(data, k):
    # estimate.rs:494-526 property
    c = pc.PointCloud.from_numpy(data)
    nn = pc.estimate_normals(c, k)._normals_numpy()
    np.testing.assert_allclose(np.linalg.norm(nn, axis=1), 1.0, atol=1e-4)


@given(clouds(min_n=1), st.floats(0.1, 2.0))
@settings(**SETTINGS)
def test_cluster_indices_valid_unique_total(data, r):
    # euclidean_cluster.rs:380-448 property: indices valid, unique; with
    # min_size=1 every finite point appears in exactly one cluster
    c = pc.PointCloud.from_numpy(data)
    clusters = pc.euclidean_cluster(c, r, 1, 10**9)
    seen = set()
    for cl in clusters:
        for i in cl:
            assert 0 <= i < c.len()
            assert i not in seen
            seen.add(i)
    finite = int(np.all(np.isfinite(data), axis=1).sum())
    assert len(seen) == c.len()  # all points (incl. non-finite singletons)
    del finite


@given(clouds(min_n=3), st.floats(0.05, 1.0), st.integers(10, 200))
@settings(**SETTINGS)
def test_ransac_inliers_within_threshold(data, t, iters):
    # ransac_plane.rs:434-464 property
    c = pc.PointCloud.from_numpy(data)
    r = pc.ransac_plane_seeded(c, t, iters, seed=7)
    n = np.array(r.normal)
    for i in r.inliers:
        assert abs(float(np.dot(n, data[i])) + r.d) <= t + 1e-4


@given(clouds(min_n=1, max_n=60))
@settings(**SETTINGS)
def test_pcd_binary_roundtrip_bit_exact(data):
    # pcd.rs:378-427 property (bit-exact binary roundtrip)
    import tempfile, os

    c = pc.PointCloud.from_numpy(data)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "t.pcd")
        pc.write_pcd_binary(p, c)
        back = pc.read_pcd(p)
    np.testing.assert_array_equal(back.to_numpy(), data)
