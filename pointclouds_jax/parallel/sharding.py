"""Multi-chip scaling: batched frames over a device mesh.

The reference's only parallelism is intra-process rayon (SURVEY.md C22).
The scaling axes here are:
- ``frames``: data parallelism over independent LiDAR frames — the
  throughput axis for streaming perception workloads; zero cross-chip
  communication.
- ``points``: sharding the point dimension of each frame — XLA/GSPMD
  partitions the sorts, gathers, and reductions inside the pipeline and
  inserts the collectives (all-gathers for the grid sort, psums for the
  global SOR statistics) over the device interconnect.

Run `dryrun_multichip` in __graft_entry__.py on a virtual CPU mesh to
validate the sharded program compiles and executes without real chips.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..pipelines.aerial import aerial_pipeline
from ..pipelines.kitti import kitti_obstacle_pipeline


def make_mesh(n_devices: int | None = None, points: int | None = None) -> Mesh:
    """2D (frames, points) mesh over the first n devices. The mesh follows
    the algorithm only: devices are taken in `jax.devices()` order, with
    no interconnect topology assumed.

    ``points`` (default: 2 when n is even, else 1) is the size of the
    point-sharding axis; it must divide n."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"mesh of {n} devices, only {len(devs)} present")
    devs = devs[:n]
    if points is None:
        # Favor the frames axis (embarrassingly parallel); keep a points
        # axis whenever the device count allows so the point-sharded code
        # path is exercised.
        points = 2 if n % 2 == 0 and n >= 2 else 1
    if n % points:
        raise ValueError(f"points={points} does not divide {n} devices")
    frames = n // points
    arr = np.array(devs[: frames * points]).reshape(frames, points)
    return Mesh(arr, ("frames", "points"))


def sharded_kitti_pipeline(
    mesh: Mesh,
    *,
    sor_k: int = 20,
    ransac_iters: int = 100,
    obstacle_cap: int = 2048,
    **pipeline_kwargs,
):
    """Returns a jitted function (batch_xyz [B,N,3], batch_valid [B,N],
    params...) -> batched pipeline outputs, with B sharded over ``frames``
    and N sharded over ``points``. ``pipeline_kwargs`` are further static
    options of `kitti_obstacle_pipeline` (e.g. ``ds_cap``,
    ``ransac_subsample``)."""

    def frame_fn(xyz, valid, voxel, sor_std, r_thresh, seed, cluster_r):
        return kitti_obstacle_pipeline(
            xyz,
            valid,
            voxel,
            sor_std,
            r_thresh,
            seed,
            cluster_r,
            sor_k=sor_k,
            ransac_iters=ransac_iters,
            obstacle_cap=obstacle_cap,
            **pipeline_kwargs,
        )

    vm = jax.vmap(
        frame_fn, in_axes=(0, 0, None, None, None, 0, None)
    )

    data_sharding = NamedSharding(mesh, P("frames", "points"))
    xyz_sharding = NamedSharding(mesh, P("frames", "points", None))
    seed_sharding = NamedSharding(mesh, P("frames"))
    scalar = NamedSharding(mesh, P())

    return jax.jit(
        vm,
        in_shardings=(
            xyz_sharding,
            data_sharding,
            scalar,
            scalar,
            scalar,
            seed_sharding,
            scalar,
        ),
    )


def sharded_aerial_pipeline(
    mesh: Mesh,
    *,
    normals_k: int = 15,
    ransac_iters: int = 100,
    obstacle_cap: int = 4096,
    cluster_wr: int = 12,
):
    """Batched aerial pipeline over the (frames, points) mesh — same
    contract as `sharded_kitti_pipeline`: batch over ``frames``, each
    frame's point dimension sharded over ``points`` (GSPMD partitions the
    voxel/moments/cluster sorts and inserts the collectives).

    (batch_xyz [B,N,3], batch_valid [B,N], voxel, normals_cell,
    ransac_thresh, seeds [B], cluster_r, viewpoint [3]) -> batched
    AerialPipelineOutput."""

    def frame_fn(
        xyz, valid, voxel, normals_cell, r_thresh, seed, cluster_r, vp
    ):
        return aerial_pipeline(
            xyz,
            valid,
            voxel,
            normals_cell,
            r_thresh,
            seed,
            cluster_r,
            vp,
            normals_k=normals_k,
            ransac_iters=ransac_iters,
            obstacle_cap=obstacle_cap,
            cluster_wr=cluster_wr,
        )

    vm = jax.vmap(
        frame_fn, in_axes=(0, 0, None, None, None, 0, None, None)
    )

    data_sharding = NamedSharding(mesh, P("frames", "points"))
    xyz_sharding = NamedSharding(mesh, P("frames", "points", None))
    seed_sharding = NamedSharding(mesh, P("frames"))
    scalar = NamedSharding(mesh, P())

    return jax.jit(
        vm,
        in_shardings=(
            xyz_sharding,
            data_sharding,
            scalar,
            scalar,
            scalar,
            seed_sharding,
            scalar,
            scalar,
        ),
    )
