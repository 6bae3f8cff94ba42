"""Core PointCloud container behavior (parity with the reference bindings:
crates/python/src/cloud.rs + crates/core/src/cloud.rs semantics)."""

import numpy as np
import pytest

import pointclouds_jax as pc


def test_empty_cloud():
    c = pc.PointCloud()
    assert c.len() == 0
    assert c.is_empty()
    assert len(c) == 0
    out = c.to_numpy()
    assert out.shape == (0, 3) or out.size == 0


def test_from_numpy_roundtrip_f32():
    data = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], dtype=np.float32)
    c = pc.PointCloud.from_numpy(data)
    assert c.len() == 3
    assert not c.is_empty()
    np.testing.assert_allclose(c.to_numpy(), data, atol=1e-6)


def test_from_numpy_f64_autocast():
    data = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], dtype=np.float64)
    c = pc.PointCloud.from_numpy(data)
    assert c.len() == 2
    np.testing.assert_allclose(c.to_numpy(), data.astype(np.float32), atol=1e-6)


def test_from_numpy_rejects_fortran_order():
    data = np.asfortranarray([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], dtype=np.float32)
    with pytest.raises(ValueError):
        pc.PointCloud.from_numpy(data)


def test_from_numpy_rejects_wrong_shapes():
    with pytest.raises(Exception):
        pc.PointCloud.from_numpy(np.array([1.0, 2.0, 3.0], dtype=np.float32))
    with pytest.raises(Exception):
        pc.PointCloud.from_numpy(
            np.array([[1.0, 2.0], [3.0, 4.0]], dtype=np.float32)
        )


def test_from_numpy_rejects_wrong_dtype():
    with pytest.raises(TypeError):
        pc.PointCloud.from_numpy(np.zeros((4, 3), dtype=np.int32))
    with pytest.raises(TypeError):
        pc.PointCloud.from_numpy([[1.0, 2.0, 3.0]])


def test_nan_inf_values_accepted():
    data = np.array(
        [[np.nan, 0, 0], [np.inf, 0, 0], [1, 2, 3]], dtype=np.float32
    )
    c = pc.PointCloud.from_numpy(data)
    assert c.len() == 3
    out = c.to_numpy()
    assert np.isnan(out[0, 0])
    assert np.isinf(out[1, 0])


def test_repr():
    assert "PointCloud" in repr(pc.PointCloud())
    c = pc.PointCloud.from_numpy(np.zeros((5, 3), dtype=np.float32))
    assert repr(c) == "PointCloud(n=5)"


def test_select_gathers_in_given_order():
    data = np.arange(30, dtype=np.float32).reshape(10, 3)
    c = pc.PointCloud.from_numpy(data)
    out = c.select([7, 2, 2, 0])
    assert out.len() == 4
    np.testing.assert_allclose(out.to_numpy(), data[[7, 2, 2, 0]])


def test_select_bounds_checked():
    c = pc.PointCloud.from_numpy(np.zeros((3, 3), dtype=np.float32))
    with pytest.raises(IndexError):
        c.select([0, 3])
    with pytest.raises(IndexError):
        c.select_inverse([5])


def test_select_inverse_preserves_order():
    data = np.arange(18, dtype=np.float32).reshape(6, 3)
    c = pc.PointCloud.from_numpy(data)
    out = c.select_inverse([1, 4])
    assert out.len() == 4
    np.testing.assert_allclose(out.to_numpy(), data[[0, 2, 3, 5]])


def test_select_inverse_empty_index_set_keeps_all():
    data = np.random.rand(5, 3).astype(np.float32)
    c = pc.PointCloud.from_numpy(data)
    out = c.select_inverse([])
    np.testing.assert_allclose(out.to_numpy(), data)


def test_select_carries_normals():
    data = np.random.rand(50, 3).astype(np.float32)
    c = pc.PointCloud.from_numpy(data)
    with_normals = pc.estimate_normals(c, 5)
    sel = with_normals.select([3, 1, 4])
    nn = sel._normals_numpy()
    full = with_normals._normals_numpy()
    np.testing.assert_allclose(nn, full[[3, 1, 4]])


def test_large_cloud_roundtrip():
    data = np.random.rand(10_000, 3).astype(np.float32) * 100
    c = pc.PointCloud.from_numpy(data)
    assert c.len() == 10_000
    np.testing.assert_array_equal(c.to_numpy(), data)
