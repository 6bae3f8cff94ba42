"""Tiled aerial pipeline (parallel/tiles.py:tiled_aerial_pipeline) parity
against the unsharded fused aerial pipeline on the virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from pointclouds_jax.core.cloud import make_cloud_arrays
from pointclouds_jax.parallel.tiles import tiled_aerial_pipeline
from pointclouds_jax.pipelines.aerial import aerial_pipeline
from pointclouds_jax.pipelines.scenes import aerial_scene

SCALE = 0.06
B = 2


def _mesh(frames, points):
    devs = np.array(jax.devices()[: frames * points]).reshape(frames, points)
    return Mesh(devs, ("frames", "points"))


@pytest.fixture(scope="module")
def aerial_tiled_out():
    frames = [
        make_cloud_arrays(aerial_scene(seed=s, scale=SCALE)) for s in range(B)
    ]
    xs = jnp.stack([f.xyz for f in frames])
    vs = jnp.stack([f.valid for f in frames])
    mesh = _mesh(B, 2)
    vp = jnp.asarray([0.0, 0.0, 10000.0], jnp.float32)
    step = tiled_aerial_pipeline(
        mesh, xs.shape[1], ransac_iters=100, obstacle_cap=16384,
        ransac_subsample=None,
    )
    out = step(
        xs, vs, jnp.float32(0.5), jnp.float32(0.3),
        jnp.arange(B, dtype=jnp.int32), jnp.float32(2.0), vp,
    )
    jax.block_until_ready(out)
    refs = [
        aerial_pipeline(
            f.xyz, f.valid, jnp.float32(0.5), jnp.float32(3.0),
            jnp.float32(0.3), s, jnp.float32(2.0), vp,
            ransac_iters=100, obstacle_cap=16384,
        )
        for s, f in enumerate(frames)
    ]
    return frames, out, refs


def test_tiled_aerial_flags_clean(aerial_tiled_out):
    _, out, _ = aerial_tiled_out
    assert not np.asarray(out.flags).any()


def test_tiled_aerial_centroid_sets_match(aerial_tiled_out):
    frames, out, refs = aerial_tiled_out
    for b, ref in enumerate(refs):
        want = np.asarray(ref.centroids)[np.asarray(ref.downsampled_valid)]
        got = np.asarray(out.centroids[b])[
            np.asarray(out.downsampled_valid[b])
        ]
        assert got.shape == want.shape
        w = want[np.lexsort(want.T)]
        g = got[np.lexsort(got.T)]
        np.testing.assert_allclose(g, w, rtol=3e-7, atol=1e-6)


def test_tiled_aerial_plane_matches(aerial_tiled_out):
    frames, out, refs = aerial_tiled_out
    for b, ref in enumerate(refs):
        n_t = np.asarray(out.plane_normal[b])
        n_r = np.asarray(ref.plane_normal)
        assert abs(abs(float(n_t @ n_r)) - 1.0) < 5e-3, (b, n_t, n_r)


def test_tiled_aerial_normals_match(aerial_tiled_out):
    """Owned-row normals must match the unsharded pipeline's. Rows
    CERTIFIED in both paths saw provably complete candidate sets (the
    1-cell halo covers the moments window), so their normals must agree
    tightly; UNcertified rows keep candidates-found normals whose walk
    order differs between the paths (same contract as the unsharded
    pipeline's own flagged rows) — held to the loose median check only.
    Rows matched by coordinates (row orders differ)."""
    frames, out, refs = aerial_tiled_out
    for b, ref in enumerate(refs):
        rv = np.asarray(ref.downsampled_valid)
        rc = np.round(np.asarray(ref.centroids)[rv], 4)
        rn = np.asarray(ref.normals)[rv]
        rok = np.asarray(ref.normals_ok)[rv]
        tv = np.asarray(out.downsampled_valid[b])
        tc = np.round(np.asarray(out.centroids[b])[tv], 4)
        tn = np.asarray(out.normals[b])[tv]
        tok = np.asarray(out.normals_ok[b])[tv]
        rmap = {tuple(c): (n, o) for c, n, o in zip(rc.tolist(), rn, rok)}
        dots, cert_dots = [], []
        for c, n, o in zip(tc.tolist(), tn, tok):
            w = rmap.get(tuple(c))
            if w is not None:
                d = abs(float(np.dot(n, w[0])))
                dots.append(d)
                if o and w[1]:
                    cert_dots.append(d)
        dots = np.asarray(dots)
        cert_dots = np.asarray(cert_dots)
        assert len(dots) > 0.999 * len(tc)
        # At this reduced test density few rows certify (~2% — the same
        # fraction in BOTH paths, itself a parity signal); the certified
        # ones must agree tightly, the rest to the loose global checks.
        assert len(cert_dots) > 0
        assert np.median(dots) > 0.9999
        assert (dots > 0.999).mean() > 0.97, (b, (dots > 0.999).mean())
        assert (cert_dots > 0.999).mean() > 0.999, (
            b, (cert_dots > 0.999).mean()
        )


def _clusters_as_sets(xyz, valid, labels, min_size):
    xyz = np.round(np.asarray(xyz, np.float64), 4)
    valid = np.asarray(valid)
    labels = np.asarray(labels)
    out = []
    for lab in np.unique(labels[valid]):
        rows = np.nonzero(valid & (labels == lab))[0]
        if len(rows) >= min_size:
            out.append(frozenset(map(tuple, xyz[rows].tolist())))
    return sorted(out, key=lambda s: (-len(s), sorted(s)[0]))


def test_tiled_aerial_clusters_geometrically_equal(aerial_tiled_out):
    frames, out, refs = aerial_tiled_out
    for b, ref in enumerate(refs):
        ref_xyz = np.asarray(jnp.take(ref.centroids, ref.obstacle_src, axis=0))
        got = _clusters_as_sets(
            out.obstacle_xyz[b], out.obstacle_valid[b], out.labels[b], 20
        )
        want = _clusters_as_sets(
            ref_xyz, np.asarray(ref.obstacle_valid), np.asarray(ref.labels), 20
        )
        assert len(got) == len(want), (b, len(got), len(want))
        for g, w in zip(got, want):
            assert g == w, (b, len(g), len(w), len(g & w))
