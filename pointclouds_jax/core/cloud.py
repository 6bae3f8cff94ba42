"""Core point-cloud data model: masked fixed-shape SoA arrays.

JAX redesign of the reference's ``PointCloud`` SoA container
(ref: crates/core/src/cloud.rs:3-25). Instead of dynamically sized
``Vec<f32>`` per axis, points live in a padded ``f32[N, 3]`` array plus a
``bool[N]`` validity mask, where N is drawn from a power-of-two bucket
ladder so XLA compilations are cached across calls. Every op consumes and
produces masked arrays; real lengths only materialize at host API
boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

MIN_BUCKET = 8


def bucket_size(n: int) -> int:
    """Smallest power-of-two capacity >= n (minimum MIN_BUCKET).

    Keeps the set of distinct padded shapes small so jit caches stay warm
    (SURVEY.md section 7 "Padded fixed shapes everywhere").
    """
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    return 1 << (n - 1).bit_length()


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CloudArrays:
    """Device-side pytree for a (padded) point cloud.

    Fields mirror the reference container (xyz positions, optional normals,
    colors, intensity — ref: crates/core/src/cloud.rs:3-11) but as fixed
    padded arrays with an explicit validity mask.
    """

    xyz: jax.Array  # f32[N, 3]
    valid: jax.Array  # bool[N]
    normals: Optional[jax.Array] = None  # f32[N, 3]
    colors: Optional[jax.Array] = None  # uint8[N, 3]
    intensity: Optional[jax.Array] = None  # f32[N]

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


def make_cloud_arrays(
    xyz: np.ndarray,
    normals: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    intensity: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
) -> CloudArrays:
    """Pad host arrays up to a bucket capacity and move them to device."""
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    cap = bucket_size(n) if capacity is None else capacity
    assert cap >= n

    def pad(a, dtype, width):
        a = np.asarray(a, dtype=dtype)
        out = np.zeros((cap,) + width, dtype=dtype)
        out[:n] = a.reshape((n,) + width)
        return jnp.asarray(out)

    valid = np.zeros((cap,), dtype=bool)
    valid[:n] = True
    return CloudArrays(
        xyz=pad(xyz, np.float32, (3,)),
        valid=jnp.asarray(valid),
        normals=None if normals is None else pad(normals, np.float32, (3,)),
        colors=None if colors is None else pad(colors, np.uint8, (3,)),
        intensity=None if intensity is None else pad(intensity, np.float32, ()),
    )


# ── Masked primitives (jittable) ─────────────────────────────────────────────


def count(arrs: CloudArrays) -> jax.Array:
    """Number of valid points (traced i32 scalar)."""
    return jnp.sum(arrs.valid.astype(jnp.int32))


def compaction_order(valid: jax.Array) -> jax.Array:
    """Permutation placing valid rows first, preserving relative order.

    Keeping the original order of retained points matches the
    order-preserving ``select`` semantics of the reference
    (ref: crates/core/src/cloud.rs:103-162). Computed as one stable u32
    key-value sort (valid -> 0, invalid -> 1) instead of a cumsum plus a
    dense scatter; compaction sits in every pipeline's obstacle/rescue
    packing.
    """
    n = valid.shape[0]
    kq = jnp.where(valid, jnp.uint32(0), jnp.uint32(1))
    _, order = jax.lax.sort(
        (kq, jnp.arange(n, dtype=jnp.int32)), num_keys=1
    )
    return order


def compact(arrs: CloudArrays) -> CloudArrays:
    """Move valid rows to the front (stable), masking out the tail.

    One payload-carrying stable sort: every attribute column rides the
    1-bit partition key as an independent 1-D channel, instead of
    compaction_order + per-attribute [N, 3] row gathers.
    """
    key = jnp.where(arrs.valid, jnp.uint32(0), jnp.uint32(1))
    channels = [arrs.xyz[:, 0], arrs.xyz[:, 1], arrs.xyz[:, 2]]
    if arrs.normals is not None:
        channels += [arrs.normals[:, i] for i in range(3)]
    if arrs.colors is not None:
        channels += [arrs.colors[:, i] for i in range(3)]
    if arrs.intensity is not None:
        channels.append(arrs.intensity)
    out = jax.lax.sort((key, *channels), num_keys=1, is_stable=True)
    valid = out[0] == 0
    xyz = jnp.stack(out[1:4], axis=1)
    pos = 4
    normals = colors = intensity = None
    if arrs.normals is not None:
        normals = jnp.stack(out[pos : pos + 3], axis=1)
        pos += 3
    if arrs.colors is not None:
        colors = jnp.stack(out[pos : pos + 3], axis=1)
        pos += 3
    if arrs.intensity is not None:
        intensity = out[pos]
    return CloudArrays(
        xyz=xyz,
        valid=valid,
        normals=normals,
        colors=colors,
        intensity=intensity,
    )


def mask_cloud(arrs: CloudArrays, keep: jax.Array) -> CloudArrays:
    """Restrict validity to ``keep`` (no reordering)."""
    return dataclasses.replace(arrs, valid=jnp.logical_and(arrs.valid, keep))


def gather_cloud(arrs: CloudArrays, indices: jax.Array, valid: jax.Array) -> CloudArrays:
    """Gather rows by index (all attributes ride along).

    Analogue of ``PointCloud::select`` (ref: crates/core/src/cloud.rs:103-140).
    """
    idx = jnp.clip(indices, 0, arrs.capacity - 1)

    def take(a):
        return None if a is None else jnp.take(a, idx, axis=0)

    return CloudArrays(
        xyz=take(arrs.xyz),
        valid=valid,
        normals=take(arrs.normals),
        colors=take(arrs.colors),
        intensity=take(arrs.intensity),
    )


def aabb(xyz: jax.Array, valid: jax.Array):
    """Masked axis-aligned bounding box.

    Skips non-finite points like the reference ``Aabb::expand_with_point``
    (ref: crates/core/src/bbox.rs:21-37). Returns (min[3], max[3], is_empty).
    """
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    use = jnp.logical_and(valid, finite)[:, None]
    mn = jnp.min(jnp.where(use, xyz, jnp.inf), axis=0)
    mx = jnp.max(jnp.where(use, xyz, -jnp.inf), axis=0)
    empty = jnp.logical_not(jnp.any(use))
    return mn, mx, empty


def apply_rigid(xyz: jax.Array, rotation: jax.Array, translation: jax.Array) -> jax.Array:
    """R @ p + t for every point (ref: crates/registration/src/icp.rs:39-47)."""
    return (
        jax.lax.dot(xyz, rotation.T, precision=jax.lax.Precision.HIGHEST)
        + translation[None, :]
    )
