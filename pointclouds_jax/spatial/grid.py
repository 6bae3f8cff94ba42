"""Grid-hash spatial index: the batched replacement for the KD-tree.

The reference wraps kiddo's ImmutableKdTree (ref: crates/spatial/src/kdtree.rs)
— a pointer-chasing structure that does not map to batched array code. Here
points are bucketed into cubic cells, sorted by a packed 63-bit cell key, and
neighbor queries gather bounded candidate sets from the 27-cell neighborhood
via vectorized binary search over the sorted keys. Exactness is certified per
query (kth-neighbor distance vs cell size, candidate-cap overflow) so callers
can retry with a larger cell or cap — queries never silently return
approximate results.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

BITS = 21
BIAS = 1 << 20
# Largest int64 key: sorts after every real cell key so invalid/padded points
# land at the tail of the sorted order.
INVALID_KEY = np.int64((1 << 63) - 1)

# Static 27-cell neighborhood offsets, lexicographic.
NEIGHBOR_OFFSETS = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int32,
)


def cell_coords(xyz: jax.Array, cell_size) -> jax.Array:
    """floor(p / cell) as int32, clamped to the packable range.

    Matches the reference's cell key computation
    (ref: crates/filters/src/voxel_downsample.rs:32-36,
    crates/segmentation/src/euclidean_cluster.rs:50-59). Clamping is
    monotone, so it can only merge far-apart cells, never separate adjacent
    ones — neighbor-search exactness is preserved.
    """
    c = jnp.floor(xyz / cell_size)
    c = jnp.clip(c, float(-BIAS), float(BIAS - 1))
    return c.astype(jnp.int32)


def pack_cell_key(coords: jax.Array) -> jax.Array:
    """Pack int32[..., 3] cell coords into one int64 key.

    Component-wise bias makes all packed fields non-negative, so numeric key
    order == lexicographic (ix, iy, iz) tuple order — the ordering the
    reference gets by sorting hash-map key tuples
    (ref: crates/filters/src/voxel_downsample.rs:49-50).
    """
    c = coords.astype(jnp.int64) + BIAS
    return (c[..., 0] << (2 * BITS)) | (c[..., 1] << BITS) | c[..., 2]


class GridHash(NamedTuple):
    """Points sorted by packed cell key; invalid points sort to the tail."""

    sorted_keys: jax.Array  # i64[N]
    sorted_xyz: jax.Array  # f32[N, 3]
    sorted_idx: jax.Array  # i32[N] original row of each sorted point
    cell_size: jax.Array  # f32 scalar
    num_valid: jax.Array  # i32 scalar


def build_grid(xyz: jax.Array, valid: jax.Array, cell_size) -> GridHash:
    """Sort points by cell key. Non-finite points are excluded (treated as
    invalid), matching the reference's grid inserts that skip them
    (ref: crates/segmentation/src/euclidean_cluster.rs:110-119)."""
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    use = jnp.logical_and(valid, finite)
    keys = jnp.where(use, pack_cell_key(cell_coords(xyz, cell_size)), INVALID_KEY)
    order = jnp.argsort(keys, stable=True)
    return GridHash(
        sorted_keys=keys[order],
        sorted_xyz=xyz[order],
        sorted_idx=order.astype(jnp.int32),
        cell_size=jnp.asarray(cell_size, jnp.float32),
        num_valid=jnp.sum(use.astype(jnp.int32)),
    )


def candidate_ranges(grid: GridHash, qxyz: jax.Array) -> tuple[jax.Array, jax.Array]:
    """[Q, 27] start/end ranges into the sorted arrays for each query's
    27-cell neighborhood."""
    qc = cell_coords(qxyz, grid.cell_size)  # [Q, 3]
    nkeys = pack_cell_key(qc[:, None, :] + jnp.asarray(NEIGHBOR_OFFSETS)[None, :, :])
    starts = jnp.searchsorted(grid.sorted_keys, nkeys, side="left")
    ends = jnp.searchsorted(grid.sorted_keys, nkeys, side="right")
    return starts, ends


def gather_candidates(
    grid: GridHash,
    qxyz: jax.Array,
    q_use: jax.Array,
    m_per_cell: int,
):
    """Gather up to ``m_per_cell`` points from each of the 27 neighbor cells.

    Returns:
      cand_idx  i32[Q, 27*M] original point indices
      d2        f32[Q, 27*M] squared distances (+inf where invalid)
      cand_valid bool[Q, 27*M]
      overflow  bool scalar — some cell held more than M points (results may
                be incomplete; caller must retry with a larger M)
    """
    n = grid.sorted_xyz.shape[0]
    starts, ends = candidate_ranges(grid, qxyz)  # [Q, 27]
    overflow = jnp.any(
        jnp.logical_and(q_use[:, None], (ends - starts) > m_per_cell)
    )
    idx = starts[..., None] + jnp.arange(m_per_cell)  # [Q, 27, M]
    cand_valid = idx < ends[..., None]
    idx = jnp.clip(idx, 0, n - 1).reshape(idx.shape[0], -1)
    cand_valid = jnp.logical_and(cand_valid.reshape(idx.shape), q_use[:, None])

    cand_xyz = jnp.take(grid.sorted_xyz, idx, axis=0)  # [Q, 27M, 3]
    cand_idx = jnp.take(grid.sorted_idx, idx, axis=0)
    diff = cand_xyz - qxyz[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(cand_valid, d2, jnp.inf)
    return cand_idx, d2, cand_valid, overflow
