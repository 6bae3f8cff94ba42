"""Differential tests for sweep min-label clustering (spatial/sweep.py
sweep_cluster_labels) vs a numpy union-find oracle."""

import collections

import numpy as np
import jax.numpy as jnp
import pytest

import pointclouds_jax  # noqa: F401
from pointclouds_jax.spatial.sweep import sweep_cluster_labels


def brute_components(pts, mask, r):
    """Union-find over all pairs with distance <= r (f32)."""
    ok = mask & np.isfinite(pts).all(axis=1)
    idx = np.nonzero(ok)[0]
    P = pts[idx].astype(np.float32)
    n = len(pts)
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    d2 = ((P[:, None, :] - P[None, :, :]) ** 2).sum(-1)
    r2 = np.float32(r) * np.float32(r)
    for i, j in zip(*np.nonzero(d2 <= r2)):
        if i < j:
            ra, rb = find(idx[i]), find(idx[j])
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
    return np.array([find(i) if ok[i] else i for i in range(n)]), ok


def canon(labels, ok):
    groups = collections.defaultdict(list)
    for i in np.nonzero(ok)[0]:
        groups[labels[i]].append(i)
    return sorted(tuple(sorted(v)) for v in groups.values())


# Each test runs on two data variants (another seed, shape or offset).
VARIANTS = pytest.mark.parametrize("variant", [0, 1], ids=["data0", "data1"])

GEO_OFFSET = np.float32([4.5e5, 1.2e5, 300.0])  # UTM-scale coordinates


def _check(xyz, valid, r, wr=7):
    labels, exact = sweep_cluster_labels(
        jnp.asarray(xyz), jnp.asarray(valid), np.float32(r), wr=wr
    )
    labels = np.asarray(labels)
    expect, ok = brute_components(xyz, valid, r)
    assert bool(exact), "window overflow on a test scene"
    assert canon(labels, ok) == canon(expect, ok)
    # representative = smallest member row (cell_graph_labels contract)
    for g in canon(labels, ok):
        assert all(labels[i] == min(g) for i in g)
    return labels


def test_cluster_dense_slab_needs_wide_windows():
    """A dense slab (~350 points per cluster cell) overflows the default
    7-row windows: the certificate must say so, and wide windows must then
    reproduce union-find exactly."""
    rng = np.random.default_rng(11)
    xyz = np.vstack([
        (rng.random((3500, 3)) * [2.0, 2.0, 0.05]).astype(np.float32),
        (rng.random((596, 3)) * 12.0 + 8.0).astype(np.float32),
    ]).astype(np.float32)
    valid = np.ones(len(xyz), bool)
    _, exact7 = sweep_cluster_labels(
        jnp.asarray(xyz), jnp.asarray(valid), np.float32(0.5), wr=7
    )
    assert not bool(exact7)
    _check(xyz, valid, 0.5, wr=32)


@VARIANTS
def test_cluster_blobs_and_noise(variant):
    rng = np.random.default_rng(7 + variant)
    pts = np.vstack(
        [
            rng.normal([0, 0, 0], 0.3, (300, 3)),
            rng.normal([5, 5, 0], 0.4, (400, 3)),
            rng.normal([9, 1, 1], 0.2, (150, 3)),
            rng.random((150, 3)) * 12,
        ]
    ).astype(np.float32)
    n = len(pts)
    xyz = np.zeros((1024, 3), np.float32)
    xyz[:n] = pts
    valid = np.zeros(1024, bool)
    valid[:n] = True
    xyz[50] = np.inf
    valid[60] = False
    labels = _check(xyz, valid, 0.5)
    assert labels[50] == 50 and labels[60] == 60  # singletons keep own row


@VARIANTS
def test_cluster_chain_needs_iterations(variant):
    # A long chain exercises convergence (propagation + pointer jumping);
    # data1 is a helix, whose chain also winds through z.
    n = 400
    t = np.linspace(0, 30, n)
    z = np.cos(t) if variant else np.zeros(n)
    pts = np.column_stack([t, np.sin(t), z]).astype(np.float32)
    xyz = np.zeros((512, 3), np.float32)
    xyz[:n] = pts
    valid = np.zeros(512, bool)
    valid[:n] = True
    labels = _check(xyz, valid, 0.2)
    assert (labels[:n] == labels[0]).all()  # one chain component


@VARIANTS
def test_cluster_inclusive_boundary(variant):
    # Points at EXACTLY distance r must connect (inclusive threshold,
    # ref: crates/segmentation/src/euclidean.rs behavior). data1 shifts
    # the points to UTM-scale coordinates, where they stay exact in f32.
    xyz = np.zeros((256, 3), np.float32)
    xyz[0] = [0, 0, 0]
    xyz[1] = [1.0, 0, 0]
    xyz[2] = [2.5, 0, 0]
    if variant:
        xyz[:3] += GEO_OFFSET
    valid = np.zeros(256, bool)
    valid[:3] = True
    labels = _check(xyz, valid, 1.0)
    assert labels[0] == labels[1] == 0
    assert labels[2] == 2


@VARIANTS
def test_cluster_georeferenced(variant):
    rng = np.random.default_rng(9 + variant)
    pts = np.vstack(
        [
            rng.normal([2, 0, 0], 0.2, (200, 3)),
            rng.normal([8, 3, 1], 0.2, (200, 3)),
        ]
    ).astype(np.float32) + GEO_OFFSET * np.float32(1 + variant)
    xyz = np.zeros((512, 3), np.float32)
    xyz[: len(pts)] = pts
    valid = np.zeros(512, bool)
    valid[: len(pts)] = True
    _check(xyz, valid, 1.0)
