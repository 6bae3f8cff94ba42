"""Public Python API: drop-in surface of the reference ``pointclouds_rs``.

Exposes the exact module surface of the reference PyO3 bindings
(ref: crates/python/src/lib.rs:12-49): one ``PointCloud`` class, the
``IcpResult``/``PlaneResult`` result classes, and 15 functions with the same
names, signatures, kwargs defaults, and exception behavior
(ref: crates/python/src/{cloud,filters,normals,registration,segmentation,io}.rs).

Backing implementation is jitted JAX on padded masked arrays; real lengths
materialize only here, at the host boundary.
"""

from __future__ import annotations

import dataclasses
import math
import secrets
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .core.cloud import (
    CloudArrays,
    apply_rigid,
    bucket_size,
    compact,
    gather_cloud,
    make_cloud_arrays,
    mask_cloud,
)
from .io import las as _las
from .io import pcd as _pcd
from .io import ply as _ply
from .ops import filters as _filters
from .ops import fusedops as _fusedops
from .ops import normals as _normals
from .ops import registration as _registration
from .ops import segmentation as _segmentation
from .spatial import engine as _engine
from . import native as _native

__all__ = [
    "PointCloud",
    "IcpResult",
    "PlaneResult",
    "voxel_downsample",
    "passthrough_filter",
    "statistical_outlier_removal",
    "radius_outlier_removal",
    "estimate_normals",
    "icp_point_to_point",
    "icp_point_to_plane",
    "apply_transform",
    "euclidean_cluster",
    "ransac_plane",
    "ransac_plane_seeded",
    "knn",
    "knn_indices",
    "radius_search",
    "radius_search_unsorted",
    "read_pcd",
    "write_pcd",
    "write_pcd_binary",
    "read_ply",
    "write_ply",
    "write_ply_binary",
    "read_las",
]


# ── Jitted host-boundary helpers ─────────────────────────────────────────────


@jax.jit
def _compact_and_count(arrs: CloudArrays):
    out = compact(arrs)
    return out, jnp.sum(out.valid.astype(jnp.int32))


def _slice_arrays(arrs: CloudArrays, cap: int) -> CloudArrays:
    def cut(a):
        return None if a is None else a[:cap]

    return CloudArrays(
        xyz=cut(arrs.xyz),
        valid=cut(arrs.valid),
        normals=cut(arrs.normals),
        colors=cut(arrs.colors),
        intensity=cut(arrs.intensity),
    )


# ── PointCloud ───────────────────────────────────────────────────────────────


class PointCloud:
    """Host-facing point cloud (ref: crates/python/src/cloud.rs).

    Stores compacted padded device arrays: rows [0, len) are the points in
    order; rows beyond are masked padding.
    """

    __slots__ = ("_arrs", "_count", "_host_index", "_host_xyz")

    def __init__(self):
        self._arrs = make_cloud_arrays(np.zeros((0, 3), np.float32))
        self._count = 0

    # Internal constructor from already-compacted arrays.
    @classmethod
    def _from(cls, arrs: CloudArrays, count: int) -> "PointCloud":
        self = cls.__new__(cls)
        cap = bucket_size(count)
        if cap < arrs.capacity:
            arrs = _slice_arrays(arrs, cap)
        self._arrs = arrs
        self._count = int(count)
        return self

    @classmethod
    def _from_masked(cls, arrs: CloudArrays) -> "PointCloud":
        out, cnt = _compact_and_count(arrs)
        return cls._from(out, int(cnt))

    @staticmethod
    def from_numpy(array) -> "PointCloud":
        if not isinstance(array, np.ndarray):
            raise TypeError(
                "expected NumPy array with dtype float32 or float64, shape (N, 3)"
            )
        if array.dtype not in (np.float32, np.float64):
            raise TypeError(
                "expected NumPy array with dtype float32 or float64, shape (N, 3)"
            )
        if array.ndim != 2 or array.shape[1] != 3:
            raise ValueError("expected shape (N, 3)")
        if not array.flags["C_CONTIGUOUS"]:
            raise ValueError(
                "array must be C-contiguous (row-major). "
                "Use numpy.ascontiguousarray(arr) to convert."
            )
        data = array.astype(np.float32, copy=False)
        self = PointCloud.__new__(PointCloud)
        self._arrs = make_cloud_arrays(data)
        self._count = int(array.shape[0])
        # Host copy kept for the lazy host index: clouds are immutable, so
        # `_index()` can build from this directly instead of paying a
        # device->host fetch of the padded arrays.
        self._host_xyz = (data, np.ones((data.shape[0],), bool))
        return self

    def len(self) -> int:
        return self._count

    def is_empty(self) -> bool:
        return self._count == 0

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self._arrs.xyz)[: self._count].copy()

    def _check_indices(self, indices) -> np.ndarray:
        idx = np.asarray(list(indices), dtype=np.int64)
        if idx.size:
            bad = idx[(idx < 0) | (idx >= self._count)]
            if bad.size:
                raise IndexError(
                    f"index {int(bad[0])} out of bounds for cloud with "
                    f"{self._count} points"
                )
        return idx

    def select(self, indices) -> "PointCloud":
        idx = self._check_indices(indices)
        m = idx.shape[0]
        cap = bucket_size(m)
        idx_pad = np.zeros((cap,), np.int32)
        idx_pad[:m] = idx
        valid = np.arange(cap) < m
        out = _jit_gather(self._arrs, jnp.asarray(idx_pad), jnp.asarray(valid))
        return PointCloud._from(out, m)

    def select_inverse(self, indices) -> "PointCloud":
        idx = self._check_indices(indices)
        exclude = np.zeros((self._count,), bool)
        exclude[idx] = True
        kept = np.nonzero(~exclude)[0]
        return self.select(kept)

    def __len__(self) -> int:
        return self._count

    def __repr__(self) -> str:
        return f"PointCloud(n={self._count})"

    def _index(self):
        """Lazy build-once host cell index for single-point queries — the
        KD-tree build/query amortization analogue (ref:
        crates/spatial/src/kdtree.rs:25-44): clouds are immutable, so the
        index is built on first use and reused by every subsequent
        `radius_search`/`knn_indices`/small-batch `knn` call with no
        device dispatch at all."""
        idx = getattr(self, "_host_index", None)
        if idx is None:
            from .spatial.hostindex import HostCellIndex

            idx = HostCellIndex(*self._host_points())
            self._host_index = idx
        return idx

    def _host_points(self):
        """Host copy of (xyz, valid), cached. `from_numpy` clouds keep the
        original (unpadded) array; device-born clouds pay one fetch."""
        cached = getattr(self, "_host_xyz", None)
        if cached is None:
            cached = (
                np.asarray(self._arrs.xyz),
                np.asarray(self._arrs.valid),
            )
            self._host_xyz = cached
        return cached

    # ── Internal attribute access (not part of the reference's public
    #    binding surface, which exposes no normal/color getters) ──

    @property
    def _has_normals(self) -> bool:
        return self._arrs.normals is not None

    def _normals_numpy(self) -> Optional[np.ndarray]:
        if self._arrs.normals is None:
            return None
        return np.asarray(self._arrs.normals)[: self._count].copy()

    def _colors_numpy(self) -> Optional[np.ndarray]:
        if self._arrs.colors is None:
            return None
        return np.asarray(self._arrs.colors)[: self._count].copy()

    def _intensity_numpy(self) -> Optional[np.ndarray]:
        if self._arrs.intensity is None:
            return None
        return np.asarray(self._arrs.intensity)[: self._count].copy()


_jit_gather = jax.jit(gather_cloud)


def _cloud_from_host(
    xyz: np.ndarray, normals=None, colors=None, intensity=None
) -> PointCloud:
    self = PointCloud.__new__(PointCloud)
    self._arrs = make_cloud_arrays(xyz, normals, colors, intensity)
    self._count = int(np.asarray(xyz).reshape(-1, 3).shape[0])
    return self


# ── Result classes ───────────────────────────────────────────────────────────


@dataclasses.dataclass
class IcpResult:
    """(ref: crates/python/src/registration.rs:4-29)"""

    converged: bool
    fitness: float
    rmse: float
    num_iterations: int
    translation: list
    rotation: list

    def __repr__(self) -> str:
        return (
            f"IcpResult(converged={self.converged}, rmse={self.rmse:.6f}, "
            f"iterations={self.num_iterations})"
        )


@dataclasses.dataclass
class PlaneResult:
    """(ref: crates/python/src/segmentation.rs:19-38)"""

    normal: list
    d: float
    inliers: list

    def __repr__(self) -> str:
        return (
            f"PlaneResult(normal={self.normal}, d={self.d:.4f}, "
            f"inliers={len(self.inliers)})"
        )


# ── Filters ──────────────────────────────────────────────────────────────────


def voxel_downsample(cloud: PointCloud, voxel_size: float) -> PointCloud:
    voxel_size = float(voxel_size)
    if not math.isfinite(voxel_size) or voxel_size <= 0.0:
        raise ValueError("voxel_size must be > 0 and finite")
    if cloud.is_empty():
        return PointCloud()
    # Output attributes are dropped, like the reference's from_xyz result
    # (ref: crates/filters/src/voxel_downsample.rs:64). Single dispatch:
    # centroids come out leading-compact, count rides along.
    arrs, cnt = _fusedops.voxel_fused(
        cloud._arrs.xyz, cloud._arrs.valid, jnp.float32(voxel_size)
    )
    return PointCloud._from(arrs, int(cnt))


_AXES = {"x": 0, "X": 0, "y": 1, "Y": 1, "z": 2, "Z": 2}


def passthrough_filter(
    cloud: PointCloud, axis: str, min: float, max: float
) -> PointCloud:
    if axis not in _AXES:
        raise ValueError("axis must be 'x', 'y', or 'z'")
    if cloud.is_empty():
        return PointCloud()
    arrs, cnt = _fusedops.passthrough_fused(
        cloud._arrs, _AXES[axis], jnp.float32(min), jnp.float32(max)
    )
    return PointCloud._from(arrs, int(cnt))


def statistical_outlier_removal(
    cloud: PointCloud, k: int, std_mul: float
) -> PointCloud:
    std_mul = float(std_mul)
    if not math.isfinite(std_mul) or std_mul < 0.0:
        raise ValueError("std_mul must be >= 0 and finite")
    k = int(k)
    if k < 0:
        raise ValueError("k must be >= 0")
    if cloud.is_empty() or k == 0:
        return PointCloud()
    if cloud.len() == 1:
        # Single point: nothing to compare against, keep it (ref :10-12).
        return cloud.select([0])

    arrs = cloud._arrs
    n = arrs.capacity
    if n <= _engine.BRUTE_THRESHOLD:
        out, info = _fusedops.sor_fused_small(
            arrs, jnp.float32(std_mul), k=k
        )
        return PointCloud._from(out, int(np.asarray(info)[0]))

    # Single-dispatch fused path: in-graph cell estimate + sweep + AABB
    # rescue + static-cap exact brute rescue + keep mask + compaction.
    out, info = _fusedops.sor_fused(
        arrs, jnp.float32(std_mul), k=k, wr=_engine.SWEEP_WR,
        cap=_fusedops.fused_rescue_cap(n),
    )
    info = np.asarray(info)
    if info[1]:
        return PointCloud._from(out, int(info[0]))

    # Rare rescue-cap overflow: the multi-dispatch engine path resolves
    # every flagged row exactly (host-compacted rescue of any size).
    xyz, valid = arrs.xyz, arrs.valid
    means = _engine.sor_means(xyz, valid, k)
    keep = _jit_sor_keep(means, valid, jnp.float32(std_mul))
    return PointCloud._from_masked(mask_cloud(arrs, keep))


@jax.jit
def _jit_sor_keep(means, valid, std_mul):
    return _filters.sor_keep_mask(means, valid, std_mul)


def radius_outlier_removal(
    cloud: PointCloud, radius: float, min_neighbors: int
) -> PointCloud:
    radius = float(radius)
    if not math.isfinite(radius) or radius <= 0.0:
        raise ValueError("radius must be > 0 and finite")
    min_neighbors = int(min_neighbors)
    if cloud.is_empty():
        return PointCloud()
    arrs = cloud._arrs
    n = arrs.capacity
    if n <= _engine.BRUTE_THRESHOLD:
        out, info = _fusedops.ror_fused_small(
            arrs, jnp.float32(radius), jnp.int32(min_neighbors)
        )
        return PointCloud._from(out, int(np.asarray(info)[0]))

    out, info = _fusedops.ror_fused(
        arrs, jnp.float32(radius), jnp.int32(min_neighbors),
        wr=_engine.SWEEP_WR, cap=_fusedops.fused_rescue_cap(n),
    )
    info = np.asarray(info)
    if info[1]:
        return PointCloud._from(out, int(info[0]))

    xyz, valid = arrs.xyz, arrs.valid
    counts = _engine.radius_count_sweep(xyz, valid, radius)
    keep = jnp.logical_and(valid, counts >= min_neighbors)
    return PointCloud._from_masked(mask_cloud(arrs, keep))


# ── Normals ──────────────────────────────────────────────────────────────────


def estimate_normals(cloud: PointCloud, k: int) -> PointCloud:
    return estimate_normals_with_viewpoint(cloud, k, (0.0, 0.0, 0.0))


def estimate_normals_with_viewpoint(
    cloud: PointCloud, k: int, viewpoint
) -> PointCloud:
    """Returns a new cloud with normals attached
    (ref: crates/python/src/normals.rs:5-10)."""
    k = int(k)
    if k <= 0 or cloud.is_empty():
        # Reference attaches zero-length normals in this case; our container
        # cannot express mismatched lengths, so no normals are attached.
        # Both surfaces then fail icp_point_to_plane with a ValueError.
        return PointCloud._from(dataclasses.replace(cloud._arrs, normals=None),
                                cloud.len())
    xyz, valid = cloud._arrs.xyz, cloud._arrs.valid
    n = cloud._arrs.capacity
    vp = jnp.asarray(viewpoint, jnp.float32).reshape(3)
    if n <= _engine.BRUTE_THRESHOLD or k >= n:
        normals, _ = _fusedops.normals_fused_small(
            xyz, valid, vp, k=min(k, max(n, 1))
        )
    else:
        normals, exact = _fusedops.normals_fused(
            xyz, valid, vp, k=k, wr=_engine.SWEEP_WR,
            cap=_fusedops.fused_rescue_cap(n),
        )
        if not int(np.asarray(exact)):
            # Rescue-cap overflow: multi-dispatch engine path (rescues any
            # number of flagged rows exactly).
            normals = _engine.normals(xyz, valid, k, viewpoint)
    return PointCloud._from(
        dataclasses.replace(cloud._arrs, normals=normals), cloud.len()
    )


# ── Registration ─────────────────────────────────────────────────────────────


def _empty_icp_result(source: PointCloud, target: PointCloud) -> IcpResult:
    return IcpResult(
        converged=source.is_empty() and target.is_empty(),
        fitness=0.0,
        rmse=0.0,
        num_iterations=0,
        translation=[0.0, 0.0, 0.0],
        rotation=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
    )


def _finish_icp(packed) -> IcpResult:
    # One packed f32[16] fetch ([rot(9), trans(3), fitness, rmse,
    # converged, iterations]) instead of six separate device reads.
    v = np.asarray(packed, np.float64)
    rot = v[:9].reshape(3, 3)
    # Reference leaves rmse=inf / fitness=0 if no iteration produced
    # correspondences; it reports them as-is.
    return IcpResult(
        converged=bool(v[14] > 0.5),
        fitness=float(v[12]),
        rmse=float(v[13]),
        num_iterations=int(v[15]),
        translation=[float(x) for x in v[9:12]],
        rotation=[[float(x) for x in row] for row in rot],
    )


def _icp_rows(cloud: PointCloud) -> int:
    """Static 512-row-rounded valid count for the ICP trim (see
    registration._trim): clouds are leading-compact, so rows past this
    are pure padding; rounding keeps the number of compiled shapes small."""
    return min(cloud._arrs.capacity, max(512, -(-cloud.len() // 512) * 512))


def icp_point_to_point(
    source: PointCloud,
    target: PointCloud,
    max_iterations: int = 50,
    tolerance: float = 1e-5,
    max_correspondence_distance: float = float("inf"),
) -> IcpResult:
    if source.is_empty() or target.is_empty():
        return _empty_icp_result(source, target)
    src_rows = _icp_rows(source)
    tgt_rows = _icp_rows(target)

    out = _registration.icp_point_to_point_packed(
        source._arrs.xyz,
        source._arrs.valid,
        target._arrs.xyz,
        target._arrs.valid,
        int(max_iterations),
        jnp.float32(tolerance),
        jnp.float32(max_correspondence_distance),
        src_rows=src_rows,
        tgt_rows=tgt_rows,
    )
    return _finish_icp(out)


def icp_point_to_plane(
    source: PointCloud,
    target: PointCloud,
    max_iterations: int = 50,
    tolerance: float = 1e-5,
    max_correspondence_distance: float = float("inf"),
) -> IcpResult:
    if target._arrs.normals is None:
        raise ValueError(
            "target cloud must have normals for point-to-plane ICP. "
            "Use estimate_normals(target, k) first."
        )
    if source.is_empty() or target.is_empty():
        return _empty_icp_result(source, target)
    src_rows = _icp_rows(source)
    tgt_rows = _icp_rows(target)

    out = _registration.icp_point_to_plane_packed(
        source._arrs.xyz,
        source._arrs.valid,
        target._arrs.xyz,
        target._arrs.valid,
        target._arrs.normals,
        int(max_iterations),
        jnp.float32(tolerance),
        jnp.float32(max_correspondence_distance),
        src_rows=src_rows,
        tgt_rows=tgt_rows,
    )
    return _finish_icp(out)


def apply_transform(cloud: PointCloud, rotation, translation) -> PointCloud:
    """Applies R p + t to every point; attributes are dropped, matching the
    reference's apply_transform (ref: crates/registration/src/icp.rs:77-92)."""
    rot = jnp.asarray(rotation, jnp.float32).reshape(3, 3)
    trans = jnp.asarray(translation, jnp.float32).reshape(3)
    new_xyz = _jit_apply_rigid(cloud._arrs.xyz, rot, trans)
    return PointCloud._from(
        CloudArrays(xyz=new_xyz, valid=cloud._arrs.valid), cloud.len()
    )


_jit_apply_rigid = jax.jit(apply_rigid)


# ── Segmentation ─────────────────────────────────────────────────────────────


def euclidean_cluster(
    cloud: PointCloud, distance_threshold: float, min_size: int, max_size: int
) -> list:
    distance_threshold = float(distance_threshold)
    min_size = int(min_size)
    max_size = int(max_size)
    if cloud.is_empty() or distance_threshold <= 0.0 or min_size == 0:
        return []
    if not math.isfinite(distance_threshold):
        return []

    xyz, valid = cloud._arrs.xyz, cloud._arrs.valid
    filtered = False
    res = _engine.cluster_labels(
        xyz, valid, distance_threshold, n_valid=cloud.len(),
        size_filter=(min_size, max_size),
    )
    if res is not None:
        # Sweep path: components outside [min_size, max_size] were
        # dropped ON DEVICE (label -1) and labels are surviving-component
        # ranks — u16-fetchable regardless of singleton noise, and the
        # epilogue only touches surviving rows.
        labels_np, filtered = res
    else:
        labels_np = None
    if labels_np is None:
        # Huge extents or unbounded per-cell density: exact int64-keyed
        # fallback (grid neighbor lists + per-point label propagation).
        nbrs = _engine.radius_neighbors(xyz, valid, distance_threshold)
        if nbrs is not None:
            labels = _segmentation.propagate_labels(nbrs[0], nbrs[1], valid)
        else:
            # Even the largest candidate cap truncates (pathological
            # density): uncapped exact all-pairs propagation.
            labels = _segmentation.bruteforce_cluster_labels(
                xyz, valid, jnp.float32(distance_threshold)
            )
        labels_np = np.asarray(labels, np.int32)
    # Padding/invalid rows carry label = own row id >= len and occupy
    # exactly the tail — slice them off.
    labels_np = labels_np[: cloud.len()]

    remap = None
    if filtered:
        # Drop the sentinel (-1) rows of filtered-out components and run
        # the epilogue on the surviving subset; the compaction is
        # monotone, so canonical ordering (size desc, first-member
        # tiebreak; members ascending) survives the index remap.
        remap = np.nonzero(labels_np >= 0)[0].astype(np.int64)
        labels_np = labels_np[remap]

    # Host-side component extraction + canonical ordering
    # (ref: crates/segmentation/src/euclidean_cluster.rs:169-186).
    res = _native.cluster_epilogue(labels_np, min_size, max_size)
    if res is not None:
        # Native counting-sort epilogue: order grouped canonically
        # (size desc, first-member tiebreak; members ascending).
        order, starts = res
        if remap is not None:
            order = remap[order]
        return [
            order[s:e].tolist() for s, e in zip(starts[:-1], starts[1:])
        ]
    order = np.argsort(labels_np, kind="stable")
    sorted_labels = labels_np[order]
    if remap is not None:
        order = remap[order]
    boundaries = np.nonzero(
        np.concatenate([[True], sorted_labels[1:] != sorted_labels[:-1]])
    )[0]
    ends = np.concatenate([boundaries[1:], [len(sorted_labels)]])
    clusters = []
    for s, e in zip(boundaries, ends):
        size = e - s
        if min_size <= size <= max_size:
            # order is index-ascending within a segment (stable sorts).
            clusters.append(order[s:e].tolist())
    clusters.sort(key=lambda c: (-len(c), c))
    return clusters


def ransac_plane_seeded(
    cloud: PointCloud, distance_threshold: float, iterations: int, seed: int,
    score_subsample: int | None = None,
) -> PlaneResult:
    """``score_subsample`` is a superset knob (not in the reference
    surface): tournament hypothesis scoring — see
    ops/segmentation.ransac_plane_masked. Final inliers are always
    full-cloud either way."""
    iterations = int(iterations)
    if cloud.len() < 3 or iterations <= 0:
        return PlaneResult(normal=[0.0, 0.0, 1.0], d=0.0, inliers=[])

    # assume_compact: PointCloud's invariant is exactly the compacted
    # layout (valid rows = [0, len)), so the sampling index map — a full
    # compaction sort — is skipped.
    buf = np.asarray(
        _segmentation.ransac_plane_bytes(
            cloud._arrs.xyz,
            cloud._arrs.valid,
            jnp.float32(distance_threshold),
            int(seed) % (2**31),
            iterations,
            assume_compact=True,
            score_subsample=score_subsample,
            # Reference-parity dispatch: small clouds / few iterations
            # run the sequential adaptive-early-termination path (ref
            # ransac_plane.rs:80); the fused pipelines pass the same flag
            # so pipeline-vs-API winners stay identical
            # (tests/test_pipeline.py).
            adaptive=(score_subsample is None),
        )
    )
    # ONE fetch total: bytes [0:16] carry the f32 scalars (bitcast,
    # exact), the rest the BIT-PACKED inlier mask (8x smaller fetch);
    # list built via ndarray.tolist.
    v = buf[:16].copy().view(np.float32).astype(np.float64)
    mask_np = np.unpackbits(buf[16:], bitorder="little")[: cloud.len()]
    return PlaneResult(
        normal=[float(x) for x in v[:3]],
        d=float(v[3]),
        inliers=np.nonzero(mask_np)[0].tolist(),
    )


def ransac_plane(
    cloud: PointCloud, distance_threshold: float, iterations: int
) -> PlaneResult:
    return ransac_plane_seeded(
        cloud, distance_threshold, iterations, secrets.randbits(32)
    )


# ── I/O ──────────────────────────────────────────────────────────────────────


def read_pcd(path: str) -> PointCloud:
    try:
        xyz = _pcd.read_pcd(path)
    except OSError as e:
        raise IOError(str(e))
    return _cloud_from_host(xyz)


def write_pcd(path: str, cloud: PointCloud) -> None:
    try:
        _pcd.write_pcd(path, cloud.to_numpy())
    except OSError as e:
        raise IOError(str(e))


def write_pcd_binary(path: str, cloud: PointCloud) -> None:
    try:
        _pcd.write_pcd_binary(path, cloud.to_numpy())
    except OSError as e:
        raise IOError(str(e))


def read_ply(path: str) -> PointCloud:
    try:
        xyz, normals, colors = _ply.read_ply(path)
    except OSError as e:
        raise IOError(str(e))
    return _cloud_from_host(xyz, normals=normals, colors=colors)


def write_ply(path: str, cloud: PointCloud) -> None:
    try:
        _ply.write_ply(
            path, cloud.to_numpy(), cloud._normals_numpy(), cloud._colors_numpy()
        )
    except OSError as e:
        raise IOError(str(e))


def write_ply_binary(path: str, cloud: PointCloud) -> None:
    try:
        _ply.write_ply_binary(
            path, cloud.to_numpy(), cloud._normals_numpy(), cloud._colors_numpy()
        )
    except OSError as e:
        raise IOError(str(e))


def read_las(path: str) -> PointCloud:
    try:
        xyz, intensity = _las.read_las(path)
    except OSError as e:
        raise IOError(str(e))
    return _cloud_from_host(xyz, intensity=intensity)


# ── Spatial queries (the reference's KdTree capability, crate-level API:
#    crates/spatial/src/kdtree.rs — not exposed by its Python bindings, but
#    part of the library surface) ──────────────────────────────────────────


@partial(jax.jit, static_argnames=("rows", "k"))
def _knn_pack(d, i, v, rows: int, k: int):
    """Device-side KNN epilogue: mask invalid slots (idx -1 / dist inf)
    and pack distances + indices into one f32 buffer so the host boundary
    is a single transfer."""
    d = jnp.where(v, d, jnp.inf)[:rows, :k]
    i = jnp.where(v, i, -1)[:rows, :k]
    return jnp.concatenate([d, i.astype(jnp.float32)], axis=1)


def knn(cloud: PointCloud, queries, k: int):
    """K nearest neighbors of each query point against ``cloud``.

    Returns (indices int32[Q, k'], distances f32[Q, k']) with k' =
    min(k, len(cloud)); distances are Euclidean, ascending. Matches the
    KD-tree contract (ref: crates/spatial/src/kdtree.rs:64-80): empty
    cloud / k == 0 / non-finite query -> zero results for that query
    (marked by distance = +inf and index = -1).
    """
    k = int(k)
    q = np.ascontiguousarray(np.asarray(queries, np.float32)).reshape(-1, 3)
    if k <= 0 or cloud.is_empty() or q.shape[0] == 0:
        return (
            np.zeros((q.shape[0], 0), np.int32),
            np.zeros((q.shape[0], 0), np.float32),
        )
    k_eff = min(k, cloud.len())
    if q.shape[0] <= 128:
        # Small batches hit the cached host index: a device engine call
        # costs a full grid/sweep build + dispatches, the index costs
        # microseconds per query after its one-time build.
        index = cloud._index()
        nq = q.shape[0]
        finite = np.isfinite(q).all(axis=1)
        native = getattr(index, "_native", None)
        if native is not None and finite.all():
            # One C call for the whole batch (the per-query Python loop
            # costs ~40 us of interpreter overhead per query).
            rows_b, dd_b, cnt_b = native.knn_batch(q, k_eff)
            col = np.arange(k_eff)[None, :]
            got = col < cnt_b[:, None]
            i_out = np.where(got, rows_b, -1).astype(np.int32)
            d_out = np.where(got, dd_b, np.inf).astype(np.float32)
            return i_out, d_out
        i_out = np.full((nq, k_eff), -1, np.int32)
        d_out = np.full((nq, k_eff), np.inf, np.float32)
        for r in range(nq):
            if not finite[r]:
                continue
            rows, dd = index.knn(q[r], k_eff)
            m = len(rows)
            i_out[r, :m] = rows
            d_out[r, :m] = dd
        return i_out, d_out
    nq = q.shape[0]
    # All-points self-KNN ("k neighbors of every point") is the dominant
    # large-batch pattern. When the query batch IS the cloud's own point
    # set, serve it from the fused single-dispatch same-cloud sweep
    # (engine.knn's `qxyz is pxyz` path) instead of the cross-cloud path,
    # which sorts the query set into the cloud's frame on every call.
    hxyz, hvalid = cloud._host_points()
    if (
        nq == cloud.len()
        and hxyz.shape[0] >= nq
        and bool(hvalid[:nq].all())
        and np.array_equal(q, hxyz[:nq])
    ):
        dists, idx, nvalid = _engine.knn(
            cloud._arrs.xyz, cloud._arrs.valid,
            cloud._arrs.xyz, cloud._arrs.valid, k_eff,
        )
    else:
        qarrs = make_cloud_arrays(q)
        dists, idx, nvalid = _engine.knn(
            cloud._arrs.xyz, cloud._arrs.valid, qarrs.xyz, qarrs.valid, k_eff
        )
    if idx.shape[0] <= (1 << 24):
        # Mask on device and fetch ONE packed f32 buffer (indices are
        # exact in f32 below 2^24): 1 transfer of the needed rows instead
        # of 3 padded transfers + host wheres.
        rows = min(idx.shape[0], bucket_size(nq))
        buf = np.asarray(_knn_pack(dists, idx, nvalid, rows, k_eff))
        d = buf[:nq, :k_eff].astype(np.float32)
        i = buf[:nq, k_eff:].astype(np.int32)
        return i, d
    d = np.asarray(dists)[:nq, :k_eff]
    i = np.asarray(idx)[:nq, :k_eff].astype(np.int32)
    v = np.asarray(nvalid)[:nq, :k_eff]
    i = np.where(v, i, -1)
    d = np.where(v, d, np.inf).astype(np.float32)
    return i, d


def radius_search(cloud: PointCloud, query, radius: float):
    """Indices of points within ``radius`` (inclusive) of ``query``, sorted
    ascending (ref: crates/spatial/src/kdtree.rs:105-135). Returns [] for
    empty cloud, non-positive/non-finite radius, or non-finite query.

    Runs on device: one streaming distance pass over the cloud, only the
    match mask returns to host.
    """
    radius = float(radius)
    qa = np.asarray(query, np.float32)
    if qa.ndim == 2:
        # Superset API: a [Q, 3] query batch returns a list of lists,
        # amortizing the one-time index build across all Q queries.
        if cloud.is_empty() or radius <= 0.0 or not math.isfinite(radius):
            return [[] for _ in range(qa.shape[0])]
        index = cloud._index()
        out = []
        for row in qa:
            if not np.all(np.isfinite(row)):
                out.append([])
            else:
                out.append(np.asarray(index.radius(row, radius)).tolist())
        return out
    q = qa.reshape(3)
    if (
        cloud.is_empty()
        or radius <= 0.0
        or not math.isfinite(radius)
        or not np.all(np.isfinite(q))
    ):
        return []
    # ndarray.tolist yields Python ints directly (a per-element int()
    # loop costs ~10 us/call at typical hit counts).
    return np.asarray(cloud._index().radius(q, radius)).tolist()


def radius_search_unsorted(cloud: PointCloud, query, radius: float):
    """Same results as :func:`radius_search` with no ordering guarantee
    (ref: crates/spatial/src/kdtree.rs:139-163). The batched device search
    has no per-result sort to skip, so this shares the sorted path."""
    return radius_search(cloud, query, radius)


def knn_indices(cloud: PointCloud, query, k: int):
    """Indices of the ``k`` nearest neighbors of a single ``query`` point,
    nearest first (ref: crates/spatial/src/kdtree.rs:82-96). Returns []
    for k == 0, empty cloud, or non-finite query."""
    k = int(k)
    q = np.asarray(query, np.float32).reshape(3)
    if k <= 0 or cloud.is_empty() or not np.all(np.isfinite(q)):
        return []
    rows, _ = cloud._index().knn(q, min(k, cloud.len()))
    return np.asarray(rows).tolist()
