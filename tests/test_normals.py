"""Normal estimation behavior (parity with crates/normals/src/estimate.rs)."""

import numpy as np
import pytest

import pointclouds_jax as pc
from pointclouds_jax.ops.normals import cardano_smallest_eigvec

import jax.numpy as jnp


def _plane_cloud(n_side=12, noise=1e-4, seed=0):
    rng = np.random.default_rng(seed)
    xs = np.linspace(0, 1, n_side, dtype=np.float32)
    xx, yy = np.meshgrid(xs, xs)
    zz = rng.normal(0, noise, n_side * n_side).astype(np.float32)
    return np.column_stack([xx.ravel(), yy.ravel(), zz])


def test_plane_normals_are_unit_z():
    data = _plane_cloud()
    out = pc.estimate_normals(pc.PointCloud.from_numpy(data), 8)
    assert out.len() == len(data)
    nn = out._normals_numpy()
    assert np.all(np.abs(nn[:, 2]) > 0.999)
    np.testing.assert_allclose(np.linalg.norm(nn, axis=1), 1.0, atol=1e-5)


def test_normals_oriented_toward_origin_viewpoint():
    # Sphere around a center away from origin: normals should point back
    # toward the origin viewpoint (dot(normal, origin - p) >= 0).
    rng = np.random.default_rng(1)
    dirs = rng.normal(size=(500, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = (np.array([5.0, 5.0, 5.0]) + dirs).astype(np.float32)
    out = pc.estimate_normals(pc.PointCloud.from_numpy(pts), 10)
    nn = out._normals_numpy()
    dots = np.sum(nn * (-pts), axis=1)
    assert (dots >= -1e-6).all()


def test_normals_custom_viewpoint():
    data = _plane_cloud()
    up = pc.estimate_normals_with_viewpoint(
        pc.PointCloud.from_numpy(data), 8, (0.0, 0.0, 10.0)
    )._normals_numpy()
    down = pc.estimate_normals_with_viewpoint(
        pc.PointCloud.from_numpy(data), 8, (0.0, 0.0, -10.0)
    )._normals_numpy()
    assert np.all(up[:, 2] > 0.999)
    assert np.all(down[:, 2] < -0.999)


def test_normals_two_points_no_panic():
    data = np.array([[0, 0, 0], [1, 0, 0]], dtype=np.float32)
    out = pc.estimate_normals(pc.PointCloud.from_numpy(data), 2)
    assert out.len() == 2
    nn = out._normals_numpy()
    assert np.all(np.isfinite(nn))


def test_normals_preserves_points_and_attrs():
    data = np.random.rand(30, 3).astype(np.float32)
    c = pc.PointCloud.from_numpy(data)
    out = pc.estimate_normals(c, 5)
    np.testing.assert_array_equal(out.to_numpy(), data)


def test_normals_k_zero_attaches_nothing():
    c = pc.PointCloud.from_numpy(np.random.rand(5, 3).astype(np.float32))
    out = pc.estimate_normals(c, 0)
    assert out.len() == 5
    assert out._normals_numpy() is None


def test_cardano_matches_numpy_eigh():
    """The analytic eigensolver must agree with LAPACK on the smallest-|l|
    eigenvector (up to sign) for random covariance-like matrices."""
    rng = np.random.default_rng(2)
    for _ in range(50):
        pts = rng.normal(size=(20, 3))
        pts[:, 2] *= rng.uniform(0.001, 1.0)  # squash -> plane-ish
        cov = (pts - pts.mean(0)).T @ (pts - pts.mean(0))
        w, v = np.linalg.eigh(cov)
        lam = w[np.argmin(np.abs(w))]
        expect = v[:, np.argmin(np.abs(w))]
        got = np.asarray(
            cardano_smallest_eigvec(jnp.asarray(cov[None].astype(np.float32)))
        )[0]
        got = got / np.linalg.norm(got)
        dot = abs(np.dot(got, expect))
        assert dot > 1.0 - 1e-3, (cov, got, expect, dot)


def test_cardano_degenerate_inputs():
    zero = jnp.zeros((1, 3, 3), jnp.float32)
    out = np.asarray(cardano_smallest_eigvec(zero))[0]
    np.testing.assert_allclose(out, [0, 0, 1])
    # isotropic (identity-like) covariance -> (0,0,1) fallback (ref :174-177)
    iso = jnp.eye(3, dtype=jnp.float32)[None] * 2.5
    out = np.asarray(cardano_smallest_eigvec(iso))[0]
    np.testing.assert_allclose(out, [0, 0, 1])


def test_normals_collinear_points_default():
    # All points on a line: covariance rank 1; eigensolver must not blow up.
    data = np.column_stack(
        [np.linspace(0, 1, 20), np.zeros(20), np.zeros(20)]
    ).astype(np.float32)
    out = pc.estimate_normals(pc.PointCloud.from_numpy(data), 5)
    nn = out._normals_numpy()
    assert np.all(np.isfinite(nn))
    # normal must be orthogonal to the line direction (x)
    assert np.all(np.abs(nn[:, 0]) < 1e-3)


def test_normals_from_moment_rows_matches_knn_path():
    """The shared component-planar moments->normals helper (used by the
    aerial pipeline, normals_fused, and the engine adapter) must agree
    with the reference-shaped KNN covariance path on the same neighbor
    sets."""
    import jax.numpy as jnp

    from pointclouds_jax.ops.normals import (
        normals_from_knn,
        normals_from_moment_rows,
    )
    from pointclouds_jax.spatial.knn import bruteforce_knn

    rng = np.random.default_rng(11)
    xyz = jnp.asarray((rng.random((600, 3)) * 4).astype(np.float32))
    valid = jnp.ones((600,), bool)
    k = 12
    d, idx, nv = bruteforce_knn(xyz, valid, xyz, valid, k)
    vp = jnp.zeros((3,), jnp.float32)
    want = np.asarray(normals_from_knn(xyz, idx, nv, vp))

    # Build query-centered moment rows from the same neighbor sets.
    nb = np.asarray(jnp.take(xyz, jnp.clip(idx, 0, 599), axis=0))
    rel = np.where(np.asarray(nv)[:, :, None],
                   nb - np.asarray(xyz)[:, None, :], 0.0).astype(np.float64)
    m1r = jnp.asarray(rel.sum(axis=1).T.astype(np.float32))
    m2r = jnp.asarray(np.stack([
        (rel[:, :, 0] * rel[:, :, 0]).sum(1),
        (rel[:, :, 1] * rel[:, :, 1]).sum(1),
        (rel[:, :, 2] * rel[:, :, 2]).sum(1),
        (rel[:, :, 0] * rel[:, :, 1]).sum(1),
        (rel[:, :, 0] * rel[:, :, 2]).sum(1),
        (rel[:, :, 1] * rel[:, :, 2]).sum(1),
    ]).astype(np.float32))
    cnt = jnp.asarray(np.asarray(nv).sum(axis=1).astype(np.float32))
    got = np.asarray(normals_from_moment_rows(m1r, m2r, cnt, xyz, vp))

    # Same unit normals up to f32 covariance accumulation differences.
    dots = np.abs((got * want).sum(axis=1))
    assert (dots > 0.999).mean() > 0.98
    np.testing.assert_allclose(
        np.linalg.norm(got, axis=1), 1.0, atol=1e-4
    )
