"""Spatial-tile points-axis sharding (parallel/tiles.py): parity against
the unsharded fused pipeline on the virtual 8-device CPU mesh.

Parity contract (module docstring): voxel centroids bitwise-equal as a
SET; SOR keep decisions equal up to threshold-ULP boundary points; the
obstacle cluster decomposition geometrically equal (clusters compared as
coordinate sets — row order differs because the tiled frame gathers
tile-major instead of canonical order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from pointclouds_jax.core.cloud import make_cloud_arrays
from pointclouds_jax.ops.filters import voxel_downsample_masked
from pointclouds_jax.parallel.tiles import tiled_kitti_pipeline
from pointclouds_jax.pipelines.kitti import kitti_obstacle_pipeline
from pointclouds_jax.pipelines.scenes import kitti_scene

SCALE = 0.2
B = 4


def _mesh(frames, points):
    devs = np.array(jax.devices()[: frames * points]).reshape(frames, points)
    return Mesh(devs, ("frames", "points"))


@pytest.fixture(scope="module")
def tiled_out():
    frames = [
        make_cloud_arrays(kitti_scene(seed=s, scale=SCALE)) for s in range(B)
    ]
    xs = jnp.stack([f.xyz for f in frames])
    vs = jnp.stack([f.valid for f in frames])
    mesh = _mesh(B, 2)
    # ransac_subsample=None: the unsharded refs below use full scoring
    # (their default); with the tiled tail's canonical position_rows the
    # two paths then select bit-identical hypotheses and winners.
    step = tiled_kitti_pipeline(
        mesh, xs.shape[1], sor_k=10, ransac_iters=50, obstacle_cap=2048,
        ransac_subsample=None,
    )
    out = step(
        xs, vs, jnp.float32(0.15), jnp.float32(2.0), jnp.float32(0.15),
        jnp.arange(B, dtype=jnp.int32), jnp.float32(0.8),
    )
    jax.block_until_ready(out)
    refs = [
        kitti_obstacle_pipeline(
            f.xyz, f.valid, jnp.float32(0.15), jnp.float32(2.0),
            jnp.float32(0.15), s, jnp.float32(0.8), sor_k=10,
            ransac_iters=50, obstacle_cap=2048,
        )
        for s, f in enumerate(frames)
    ]
    return frames, out, refs


def test_tiled_flags_clean(tiled_out):
    _, out, _ = tiled_out
    assert not np.asarray(out.flags).any()


def test_tiled_voxel_centroids_set_equal(tiled_out):
    """Tile boundaries align to sor cells (whole voxels), so every voxel
    keeps its member set and relative member order — sums differ only by
    `associative_scan` tree reassociation (the voxel sits at a different
    array offset per tile), i.e. by at most an ULP. The centroid SET must
    match voxel_downsample_masked's to ULP tolerance, and all but a
    vanishing fraction bitwise."""
    frames, out, _ = tiled_out
    for b, f in enumerate(frames):
        cm, vm = voxel_downsample_masked(f.xyz, f.valid, np.float32(0.15))
        ref = np.asarray(cm)[np.asarray(vm)]
        got = np.asarray(out.centroids[b])[np.asarray(out.downsampled_valid[b])]
        assert got.shape == ref.shape
        ref_view = ref[np.lexsort(ref.T)]
        got_view = got[np.lexsort(got.T)]
        np.testing.assert_allclose(got_view, ref_view, rtol=3e-7, atol=1e-6)
        bitwise = (got_view == ref_view).all(axis=1).mean()
        assert bitwise > 0.999, (b, bitwise)


def test_tiled_cleaned_matches_unsharded(tiled_out):
    """Keep decisions equal up to threshold-boundary ULP points (the psum
    reduction order differs from the unsharded single-sum)."""
    frames, out, refs = tiled_out
    for b, ref in enumerate(refs):
        n_ref = int(np.asarray(ref.cleaned_valid).sum())
        n_tiled = int(np.asarray(out.cleaned_count[b]))
        assert abs(n_tiled - n_ref) <= max(2, n_ref // 1000), (b, n_tiled, n_ref)


def test_tiled_plane_matches_unsharded(tiled_out):
    """Same dominant ground plane (orientation-normalized) — hypothesis
    sampling order differs, the winning plane must not."""
    frames, out, refs = tiled_out
    for b, ref in enumerate(refs):
        n_t = np.asarray(out.plane_normal[b])
        n_r = np.asarray(ref.plane_normal)
        assert abs(abs(float(n_t @ n_r)) - 1.0) < 5e-3, (b, n_t, n_r)


def _clusters_as_sets(xyz, valid, labels, min_size):
    # Coordinates rounded to 0.1 mm: centroid values may differ from the
    # unsharded run by an ULP (scan-tree reassociation), which must not
    # defeat the set comparison. Points are >= voxel_size apart.
    xyz = np.round(np.asarray(xyz, np.float64), 4)
    valid = np.asarray(valid)
    labels = np.asarray(labels)
    out = []
    for lab in np.unique(labels[valid]):
        rows = np.nonzero(valid & (labels == lab))[0]
        if len(rows) >= min_size:
            pts = xyz[rows]
            out.append(frozenset(map(tuple, pts.tolist())))
    return sorted(out, key=lambda s: (-len(s), sorted(s)[0]))


def test_tiled_clusters_geometrically_equal(tiled_out):
    frames, out, refs = tiled_out
    for b, ref in enumerate(refs):
        ref_xyz = np.asarray(jnp.take(ref.centroids, ref.obstacle_src, axis=0))
        got = _clusters_as_sets(
            out.obstacle_xyz[b], out.obstacle_valid[b], out.labels[b], 10
        )
        want = _clusters_as_sets(
            ref_xyz, np.asarray(ref.obstacle_valid), np.asarray(ref.labels), 10
        )
        assert len(got) == len(want), (b, len(got), len(want))
        for g, w in zip(got, want):
            assert g == w, (b, len(g), len(w), len(g & w))


def test_tiled_points4_still_clean():
    """A 2x4 mesh (4 tiles per frame) routes through interior tiles with
    two-sided halos — flags stay clean and cleaned counts match."""
    frames = [
        make_cloud_arrays(kitti_scene(seed=s, scale=SCALE)) for s in range(2)
    ]
    xs = jnp.stack([f.xyz for f in frames])
    vs = jnp.stack([f.valid for f in frames])
    mesh = _mesh(2, 4)
    step = tiled_kitti_pipeline(
        mesh, xs.shape[1], sor_k=10, ransac_iters=50, obstacle_cap=2048
    )
    out = step(
        xs, vs, jnp.float32(0.15), jnp.float32(2.0), jnp.float32(0.15),
        jnp.arange(2, dtype=jnp.int32), jnp.float32(0.8),
    )
    jax.block_until_ready(out)
    assert not np.asarray(out.flags).any()
    for b, f in enumerate(frames):
        ref = kitti_obstacle_pipeline(
            f.xyz, f.valid, jnp.float32(0.15), jnp.float32(2.0),
            jnp.float32(0.15), b, jnp.float32(0.8), sor_k=10,
            ransac_iters=50, obstacle_cap=2048,
        )
        n_ref = int(np.asarray(ref.cleaned_valid).sum())
        n_tiled = int(np.asarray(out.cleaned_count[b]))
        assert abs(n_tiled - n_ref) <= max(2, n_ref // 1000)


def test_tiled_points1_fast_path_matches_unsharded():
    """points=1 skips routing/halos entirely (one canonical sort IS the
    merged frame) — its outputs must match the unsharded pipeline like
    the routed meshes do: clean flags, equal cleaned counts, same
    plane."""
    frames = [
        make_cloud_arrays(kitti_scene(seed=s, scale=SCALE)) for s in range(2)
    ]
    xs = jnp.stack([f.xyz for f in frames])
    vs = jnp.stack([f.valid for f in frames])
    mesh = _mesh(2, 1)
    step = tiled_kitti_pipeline(
        mesh, xs.shape[1], sor_k=10, ransac_iters=50, obstacle_cap=2048,
        ransac_subsample=None,
    )
    out = step(
        xs, vs, jnp.float32(0.15), jnp.float32(2.0), jnp.float32(0.15),
        jnp.arange(2, dtype=jnp.int32), jnp.float32(0.8),
    )
    jax.block_until_ready(out)
    assert not np.asarray(out.flags).any()
    for b, f in enumerate(frames):
        ref = kitti_obstacle_pipeline(
            f.xyz, f.valid, jnp.float32(0.15), jnp.float32(2.0),
            jnp.float32(0.15), b, jnp.float32(0.8), sor_k=10,
            ransac_iters=50, obstacle_cap=2048,
        )
        n_ref = int(np.asarray(ref.cleaned_valid).sum())
        n_tiled = int(np.asarray(out.cleaned_count[b]))
        assert abs(n_tiled - n_ref) <= max(2, n_ref // 1000), (b, n_tiled, n_ref)
        n_t = np.asarray(out.plane_normal[b])
        n_r = np.asarray(ref.plane_normal)
        assert abs(abs(float(n_t @ n_r)) - 1.0) < 5e-3, (b, n_t, n_r)
