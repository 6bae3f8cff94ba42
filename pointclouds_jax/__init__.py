"""pointclouds_jax: a JAX point-cloud processing framework.

JAX/XLA implementation with the same capabilities and Python API surface
as the Rust reference library ``pointclouds-rs``. See SURVEY.md at the repo
root for the structural map of the reference and the design decisions.

Importing this package enables JAX x64 support: the grid-hash spatial index
packs 3D cell coordinates into int64 keys. All hot-path compute remains f32.

Compilation cache: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its
persistent cache there and nothing is set here. Otherwise, unless the
process is CPU-only (``JAX_PLATFORMS=cpu``: tests and the f64 verifier,
whose XLA:CPU executables must never be reloaded from a cache), the cache
lives in ``.jax_cache`` at the checkout root.
"""

import os as _os
import pathlib as _pathlib

import jax as _jax

_jax.config.update("jax_enable_x64", True)

CACHE_DIR = _pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"

if (
    "JAX_COMPILATION_CACHE_DIR" not in _os.environ
    and _os.environ.get("JAX_PLATFORMS", "").strip().lower() != "cpu"
):
    _jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .api import (  # noqa: E402
    IcpResult,
    knn,
    knn_indices,
    radius_search,
    radius_search_unsorted,
    PlaneResult,
    PointCloud,
    apply_transform,
    estimate_normals,
    estimate_normals_with_viewpoint,
    euclidean_cluster,
    icp_point_to_plane,
    icp_point_to_point,
    passthrough_filter,
    radius_outlier_removal,
    ransac_plane,
    ransac_plane_seeded,
    read_las,
    read_pcd,
    read_ply,
    statistical_outlier_removal,
    voxel_downsample,
    write_pcd,
    write_pcd_binary,
    write_ply,
    write_ply_binary,
)

__version__ = "0.1.0"

__all__ = [
    "IcpResult",
    "knn",
    "knn_indices",
    "radius_search",
    "radius_search_unsorted",
    "PlaneResult",
    "PointCloud",
    "apply_transform",
    "estimate_normals",
    "estimate_normals_with_viewpoint",
    "euclidean_cluster",
    "icp_point_to_plane",
    "icp_point_to_point",
    "passthrough_filter",
    "radius_outlier_removal",
    "ransac_plane",
    "ransac_plane_seeded",
    "read_las",
    "read_pcd",
    "read_ply",
    "statistical_outlier_removal",
    "voxel_downsample",
    "write_pcd",
    "write_pcd_binary",
    "write_ply",
    "write_ply_binary",
]
