"""Multi-chip sharding validation on the virtual 8-device CPU mesh
(provisioned by tests/conftest.py). Mirrors the driver's dryrun_multichip:
mesh construction, jit of the batched pipeline under frames x points
shardings, and per-frame output parity against the unsharded pipeline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pointclouds_jax  # noqa: F401
from pointclouds_jax.core.cloud import make_cloud_arrays
from pointclouds_jax.parallel.sharding import make_mesh, sharded_kitti_pipeline
from pointclouds_jax.pipelines.kitti import kitti_obstacle_pipeline
from pointclouds_jax.pipelines.scenes import kitti_scene


def test_make_mesh_shapes():
    mesh = make_mesh(8)
    assert dict(mesh.shape) == {"frames": 4, "points": 2}
    mesh = make_mesh(4)
    assert dict(mesh.shape) == {"frames": 2, "points": 2}
    mesh = make_mesh(1)
    assert dict(mesh.shape) == {"frames": 1, "points": 1}


@pytest.mark.parametrize("n_devices", [8, 2])
def test_sharded_pipeline_runs_and_matches_unsharded(n_devices):
    mesh = make_mesh(n_devices)
    b = mesh.shape["frames"]

    frames = [
        make_cloud_arrays(kitti_scene(seed=s, scale=0.01), capacity=2048)
        for s in range(b)
    ]
    batch_xyz = jnp.stack([f.xyz for f in frames])
    batch_valid = jnp.stack([f.valid for f in frames])
    seeds = jnp.arange(b, dtype=jnp.int32)

    step = sharded_kitti_pipeline(mesh, sor_k=10, ransac_iters=50, obstacle_cap=512)
    out = step(
        batch_xyz,
        batch_valid,
        jnp.float32(0.15),
        jnp.float32(2.0),
        jnp.float32(0.15),
        seeds,
        jnp.float32(0.8),
    )
    jax.block_until_ready(out)
    counts = np.asarray(out.downsampled_valid).sum(axis=1)
    assert (counts > 0).all()

    # Per-frame parity vs the unsharded single-frame pipeline.
    for i in range(b):
        ref = kitti_obstacle_pipeline(
            frames[i].xyz,
            frames[i].valid,
            jnp.float32(0.15),
            jnp.float32(2.0),
            jnp.float32(0.15),
            int(seeds[i]),
            jnp.float32(0.8),
            sor_k=10,
            ransac_iters=50,
            obstacle_cap=512,
        )
        np.testing.assert_array_equal(
            np.asarray(out.downsampled_valid[i]), np.asarray(ref.downsampled_valid)
        )
        np.testing.assert_array_equal(
            np.asarray(out.cleaned_valid[i]), np.asarray(ref.cleaned_valid)
        )
        np.testing.assert_array_equal(
            np.asarray(out.labels[i]), np.asarray(ref.labels)
        )
        np.testing.assert_allclose(
            np.asarray(out.centroids[i]), np.asarray(ref.centroids), atol=1e-6
        )


def test_points_axis_actually_sharded():
    mesh = make_mesh(8)
    arrs = make_cloud_arrays(kitti_scene(seed=0, scale=0.01), capacity=2048)
    b = mesh.shape["frames"]
    batch_xyz = jnp.stack([arrs.xyz] * b)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharded = jax.device_put(batch_xyz, NamedSharding(mesh, P("frames", "points", None)))
    shard_shapes = {s.data.shape for s in sharded.addressable_shards}
    assert shard_shapes == {(b // mesh.shape["frames"] * 1, 1024, 3)}


def test_sharded_aerial_runs_and_matches_unsharded():
    from pointclouds_jax.parallel.sharding import sharded_aerial_pipeline
    from pointclouds_jax.pipelines.aerial import aerial_pipeline
    from pointclouds_jax.pipelines.scenes import aerial_scene

    mesh = make_mesh(8)
    b = mesh.shape["frames"]
    frames = [
        make_cloud_arrays(aerial_scene(seed=s, scale=0.01), capacity=4096)
        for s in range(b)
    ]
    batch_xyz = jnp.stack([f.xyz for f in frames])
    batch_valid = jnp.stack([f.valid for f in frames])
    seeds = jnp.arange(b, dtype=jnp.int32)
    vp = jnp.asarray([0.0, 0.0, 10000.0], jnp.float32)

    step = sharded_aerial_pipeline(
        mesh, normals_k=15, ransac_iters=50, obstacle_cap=1024
    )
    out = step(
        batch_xyz,
        batch_valid,
        jnp.float32(0.5),
        jnp.float32(6.0),
        jnp.float32(0.3),
        seeds,
        jnp.float32(2.0),
        vp,
    )
    jax.block_until_ready(out)
    assert (np.asarray(out.downsampled_valid).sum(axis=1) > 0).all()

    for i in range(b):
        ref = aerial_pipeline(
            frames[i].xyz,
            frames[i].valid,
            jnp.float32(0.5),
            jnp.float32(6.0),
            jnp.float32(0.3),
            int(seeds[i]),
            jnp.float32(2.0),
            vp,
            normals_k=15,
            ransac_iters=50,
            obstacle_cap=1024,
        )
        np.testing.assert_array_equal(
            np.asarray(out.downsampled_valid[i]),
            np.asarray(ref.downsampled_valid),
        )
        np.testing.assert_array_equal(
            np.asarray(out.labels[i]), np.asarray(ref.labels)
        )
        np.testing.assert_allclose(
            np.asarray(out.normals[i]), np.asarray(ref.normals), atol=1e-5
        )
