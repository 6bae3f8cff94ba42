"""Exactness at georeferenced (UTM-scale) coordinate offsets.

The |q|^2+|p|^2-2qp matmul-form distance carries an absolute f32 error
~eps*|q|^2 that at 1e5-scale offsets (exactly what read_las returns) dwarfs
real neighbor distances. The fix centers coordinates on the cloud AABB
midpoint before the matmul (distances are translation-invariant). These
tests lock that in against float64 oracles; the reference (kiddo) computes
difference-based distances and is correct on identical f32 inputs, so this
is a parity requirement.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import pointclouds_jax  # noqa: F401
from pointclouds_jax import api
from pointclouds_jax.core.cloud import make_cloud_arrays
from pointclouds_jax.spatial import engine
from pointclouds_jax.spatial.knn import bruteforce_knn


def _cloud(data):
    arrs = make_cloud_arrays(data)
    return arrs.xyz, arrs.valid


def np_knn_f64(data, q, k):
    d = np.linalg.norm(
        data[None, :, :].astype(np.float64) - q[:, None, :].astype(np.float64),
        axis=2,
    )
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, axis=1), idx


OFFSETS = [5e4, 2e5, 5e5]


@pytest.mark.parametrize("offset", OFFSETS)
def test_bruteforce_knn_at_utm_offset(offset):
    # 10 m-span cloud at a UTM-scale offset: the unconditional brute-force
    # path for clouds <= BRUTE_THRESHOLD.
    rng = np.random.default_rng(7)
    data = (rng.random((1500, 3)) * 10 + offset).astype(np.float32)
    xyz, valid = _cloud(data)
    dists, idx, nvalid = bruteforce_knn(xyz, valid, xyz, valid, 5)
    dists = np.asarray(dists)[: len(data)]
    assert np.asarray(nvalid)[: len(data)].all()
    expect_d, _ = np_knn_f64(data, data, 5)
    # f32 coordinate subtraction of nearby values is exact; sqrt rounds once.
    np.testing.assert_allclose(dists, expect_d, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("offset", OFFSETS)
def test_engine_knn_at_utm_offset(offset):
    rng = np.random.default_rng(11)
    data = (rng.random((4096, 3)) * 10 + offset).astype(np.float32)
    xyz, valid = _cloud(data)
    dists, idx, nvalid = engine.knn(xyz, valid, xyz, valid, 8)
    dists = np.asarray(dists)[: len(data)]
    assert np.asarray(nvalid)[: len(data)].all()
    expect_d, _ = np_knn_f64(data, data, 8)
    np.testing.assert_allclose(dists, expect_d, rtol=1e-5, atol=1e-4)


def test_icp_recovers_translation_at_utm_offset():
    # ICP with clouds at offset 2e5: the matmul-form argmin in _nn_1 used to
    # diverge completely here (translation ~4e5 instead of 0.5).
    rng = np.random.default_rng(3)
    base = (rng.random((800, 3)) * 10).astype(np.float32) + np.array(
        [2e5, 2e5, 0], np.float32
    )
    shift = np.array([0.5, -0.3, 0.2], np.float32)
    src = api.PointCloud.from_numpy(base)
    tgt = api.PointCloud.from_numpy(base + shift)
    res = api.icp_point_to_point(src, tgt, max_iterations=50, tolerance=1e-7)
    assert res.converged
    np.testing.assert_allclose(res.translation, shift, atol=2e-2)
    np.testing.assert_allclose(res.rotation, np.eye(3), atol=1e-3)


def test_sor_at_utm_offset_keeps_inliers_removes_outlier():
    rng = np.random.default_rng(5)
    dense = (rng.random((3000, 3)) * 4 + 4e5).astype(np.float32)
    outlier = np.array([[4e5 + 80, 4e5 + 80, 4e5 + 80]], np.float32)
    cloud = api.PointCloud.from_numpy(np.vstack([dense, outlier]))
    out = api.statistical_outlier_removal(cloud, 10, 2.0)
    kept = out.to_numpy()
    assert len(kept) < cloud.len()
    assert not (np.abs(kept - outlier).max(axis=1) < 1e-3).any()
