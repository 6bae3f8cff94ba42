"""ICP registration behavior (parity with crates/registration/src/icp.rs and
icp_plane.rs; tolerances follow the reference's own tests)."""

import numpy as np
import pytest

import pointclouds_jax as pc


def _cube(n=6):
    g = np.linspace(0, 1, n, dtype=np.float32)
    xx, yy, zz = np.meshgrid(g, g, g)
    return np.column_stack([xx.ravel(), yy.ravel(), zz.ravel()])


def test_icp_identity():
    data = _cube()
    c = pc.PointCloud.from_numpy(data)
    r = pc.icp_point_to_point(c, c)
    assert r.converged
    assert r.rmse < 0.01
    assert abs(r.fitness - 1.0) < 1e-6
    np.testing.assert_allclose(np.array(r.rotation), np.eye(3), atol=1e-4)
    np.testing.assert_allclose(r.translation, [0, 0, 0], atol=1e-4)


def test_icp_known_translation():
    # 8-corner cube, like the reference's cube_cloud() test helper: a dense
    # periodic lattice would alias under pure translation (a legitimate ICP
    # local minimum the reference also avoids in its tests, icp.rs:308-315).
    data = np.array(
        [
            [0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
            [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1],
        ],
        dtype=np.float32,
    )
    src = pc.PointCloud.from_numpy(data)
    tgt = pc.PointCloud.from_numpy(data + np.array([1.0, 0, 0], np.float32))
    r = pc.icp_point_to_point(src, tgt, max_iterations=100, tolerance=1e-8)
    assert r.converged
    assert r.rmse < 1e-3
    np.testing.assert_allclose(r.translation, [1.0, 0.0, 0.0], atol=0.05)


def test_icp_known_rotation_30deg_z():
    # Asymmetric cross shape (the reference's known_rotation_small_angle_z
    # scenario, icp.rs:371-400): ICP is a local optimizer, so the test shape
    # must have an unambiguous alignment.
    line = np.column_stack(
        [np.arange(40) * 0.25 - 5.0, np.zeros(40), np.zeros(40)]
    )
    arm = np.column_stack([np.zeros(20), np.arange(20) * 0.25, np.zeros(20)])
    data = np.vstack([line, arm]).astype(np.float32)
    a = np.pi / 6
    R = np.array(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
        np.float32,
    )
    src = pc.PointCloud.from_numpy(data)
    tgt = pc.PointCloud.from_numpy(data @ R.T)
    r = pc.icp_point_to_point(src, tgt, max_iterations=200, tolerance=1e-10)
    assert r.converged
    assert r.rmse < 0.05
    got = np.array(r.rotation)
    # Reference tolerance: epsilon = 0.1 on rotation entries (icp.rs:133-137)
    np.testing.assert_allclose(got, R, atol=0.1)
    # Transformed source should land on target (ref epsilon 0.15)
    aligned = data @ got.T + np.array(r.translation)
    np.testing.assert_allclose(aligned, data @ R.T, atol=0.15)


def test_icp_empty_clouds():
    e = pc.PointCloud()
    r = pc.icp_point_to_point(e, e)
    assert r.converged  # both empty -> converged (ref icp.rs:131-139)
    assert r.num_iterations == 0
    r2 = pc.icp_point_to_point(e, pc.PointCloud.from_numpy(_cube()))
    assert not r2.converged
    assert r2.num_iterations == 0
    np.testing.assert_allclose(np.array(r2.rotation), np.eye(3))


def test_icp_max_correspondence_distance_filters():
    data = _cube()
    src = pc.PointCloud.from_numpy(data)
    tgt = pc.PointCloud.from_numpy(data + np.array([0.05, 0, 0], np.float32))
    r = pc.icp_point_to_point(src, tgt, max_iterations=1, tolerance=1e-8,
                              max_correspondence_distance=1e-6)
    # Correspondences all filtered -> fitness 0, no transform
    assert r.fitness == 0.0
    np.testing.assert_allclose(np.array(r.rotation), np.eye(3), atol=1e-6)


def test_icp_fitness_fraction():
    data = _cube()
    src = pc.PointCloud.from_numpy(data)
    tgt = pc.PointCloud.from_numpy(data)
    r = pc.icp_point_to_point(src, tgt, max_iterations=2)
    assert 0.0 < r.fitness <= 1.0


def test_icp_plane_converges_on_shifted_plane():
    rng = np.random.default_rng(5)
    xs = np.linspace(-2, 2, 12, dtype=np.float32)
    xx, yy = np.meshgrid(xs, xs)
    zz = rng.normal(0, 1e-4, 144).astype(np.float32)
    td = np.column_stack([xx.ravel(), yy.ravel(), zz])
    target = pc.estimate_normals(pc.PointCloud.from_numpy(td), 10)
    sd = td.copy()
    sd[:, 2] += 0.3
    r = pc.icp_point_to_plane(pc.PointCloud.from_numpy(sd), target)
    assert r.converged
    assert r.translation[2] == pytest.approx(-0.3, abs=0.05)


def test_icp_plane_requires_normals():
    data = np.array([[0, 0, 0], [1, 0, 0]], dtype=np.float32)
    c = pc.PointCloud.from_numpy(data)
    with pytest.raises(ValueError):
        pc.icp_point_to_plane(c, c)


def test_icp_default_kwargs():
    # Defaults (50, 1e-5, inf) mirror crates/python/src/registration.rs:32
    data = _cube()
    c = pc.PointCloud.from_numpy(data)
    r = pc.icp_point_to_point(c, c)
    assert r.num_iterations <= 50


def test_icp_repr():
    e = pc.PointCloud()
    r = pc.icp_point_to_point(e, e)
    assert "IcpResult" in repr(r)


def test_apply_transform():
    data = np.array([[1, 0, 0], [0, 1, 0]], dtype=np.float32)
    c = pc.PointCloud.from_numpy(data)
    a = np.pi / 2
    R = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    out = pc.apply_transform(c, R, [1.0, 0.0, 0.0])
    np.testing.assert_allclose(
        out.to_numpy(), [[1, 1, 0], [0, 0, 0]], atol=1e-6
    )


def test_apply_transform_identity():
    data = np.random.rand(20, 3).astype(np.float32)
    c = pc.PointCloud.from_numpy(data)
    out = pc.apply_transform(c, np.eye(3), [0, 0, 0])
    np.testing.assert_allclose(out.to_numpy(), data, atol=1e-6)


def test_apply_transform_drops_normals():
    c = pc.estimate_normals(
        pc.PointCloud.from_numpy(np.random.rand(20, 3).astype(np.float32)), 5
    )
    out = pc.apply_transform(c, np.eye(3), [0, 0, 0])
    # Reference apply_transform returns bare xyz (icp.rs:77-92)
    assert out._normals_numpy() is None


def test_icp_converges_with_noise():
    rng = np.random.default_rng(8)
    data = (rng.random((500, 3)) * 2).astype(np.float32)
    shift = np.array([0.08, -0.05, 0.03], np.float32)
    src = pc.PointCloud.from_numpy(data)
    tgt = pc.PointCloud.from_numpy(
        data + shift + rng.normal(0, 1e-3, data.shape).astype(np.float32)
    )
    r = pc.icp_point_to_point(src, tgt, max_iterations=100)
    np.testing.assert_allclose(r.translation, shift, atol=0.02)


@pytest.mark.parametrize(
    "n_q,n_p", [(300, 500), (128, 128), (1, 7), (257, 1000)]
)
def test_nn_1_matches_f64_oracle(n_q, n_p):
    """ICP's one-shot 1-NN correspondence pass vs f64 brute force, with
    invalid rows on both sides."""
    import jax.numpy as jnp

    from pointclouds_jax.ops.registration import _nn_1

    rng = np.random.default_rng(11)
    q = (rng.random((n_q, 3)) * 10).astype(np.float32)
    p = (rng.random((n_p, 3)) * 10).astype(np.float32)
    qu = rng.random(n_q) > 0.1
    pu = rng.random(n_p) > 0.1
    pu[0] = True
    d, idx, found = map(np.asarray, _nn_1(
        jnp.asarray(q), jnp.asarray(qu), jnp.asarray(p), jnp.asarray(pu)
    ))
    d2 = ((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1)
    d2[:, ~pu] = np.inf
    np.testing.assert_array_equal(found, qu)
    np.testing.assert_allclose(
        d[qu], np.sqrt(d2[qu].min(1)), rtol=1e-5, atol=1e-5
    )
    assert (idx[qu] == d2[qu].argmin(1)).all()  # no ties in random data


def test_icp_packed_recovers_translation():
    """The jitted point-to-point ICP program aligns a cloud with its
    translated copy: the recovered transform maps source onto target."""
    import jax.numpy as jnp

    from pointclouds_jax.ops import registration as _reg

    rng = np.random.default_rng(9)
    data = (rng.random((400, 3)) * 2).astype(np.float32)
    src = pc.PointCloud.from_numpy(data)
    tgt = pc.PointCloud.from_numpy(data + np.float32(0.05))
    out = np.asarray(
        _reg.icp_point_to_point_packed(
            src._arrs.xyz, src._arrs.valid,
            tgt._arrs.xyz, tgt._arrs.valid,
            20, jnp.float32(1e-5), jnp.float32(np.inf),
        )
    )
    rot, trans = out[:9].reshape(3, 3), out[9:12]
    np.testing.assert_allclose(rot, np.eye(3), atol=1e-4)
    np.testing.assert_allclose(trans, [0.05, 0.05, 0.05], atol=1e-4)
    assert out[13] < 1e-4  # rmse
