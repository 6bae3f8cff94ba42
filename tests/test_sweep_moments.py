"""KNN-moments sweep (spatial/sweep.py sweep_knn_moments) vs an f64
brute-force oracle.

The moments pass re-derives squared distances against the kth threshold,
so it uses BANDED inclusion (sweep.D2_BAND) to stay deterministic under
per-consumer FMA contraction; certified rows must be exactly the true
top-k. These tests pin certified rows' first and second moments and counts
against f64 brute force, at several shapes and at georeferenced offsets,
and the tie flagging of duplicate points.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pointclouds_jax.spatial.sweep import sweep_knn_moments

EPS32 = float(np.finfo(np.float32).eps)


def _cloud(seed, n, invalid_frac=0.1, offset=0.0):
    rng = np.random.default_rng(seed)
    xyz = (rng.uniform(0, 10, (n, 3)) + offset).astype(np.float32)
    valid = rng.random(n) > invalid_frac
    bad = ~valid & (rng.random(n) > 0.5)
    xyz[bad] = np.nan
    return xyz, valid


def _check_certified(xyz, valid, k, cell, min_certified, rows=80):
    """Certified rows' (m1, m2, count) vs f64 brute force on a sample of
    rows. Tolerance: 64 f32 ulps of the sum of |terms| — each
    query-centred term carries <= 3 roundings and the k-term sum <= k."""
    m1, m2, cnt, ok = (
        np.asarray(x)
        for x in sweep_knn_moments(
            jnp.asarray(xyz), jnp.asarray(valid), np.float32(cell), k=k
        )
    )
    fin = np.isfinite(xyz).all(1) & valid
    assert not ok[~fin].any()
    fxyz = xyz[fin].astype(np.float64)
    idx = np.nonzero(ok)[0]
    assert len(idx) >= min_certified
    for i in idx[:: max(1, len(idx) // rows)]:
        q = xyz[i].astype(np.float64)
        d2 = ((fxyz - q) ** 2).sum(1)
        o = np.argsort(d2)
        rel = fxyz[o[:k]] - q
        prods = np.stack([
            rel[:, 0] ** 2, rel[:, 1] ** 2, rel[:, 2] ** 2,
            rel[:, 0] * rel[:, 1], rel[:, 0] * rel[:, 2],
            rel[:, 1] * rel[:, 2],
        ], axis=1)
        np.testing.assert_array_less(
            np.abs(m1[i] - rel.sum(0)),
            64 * EPS32 * np.abs(rel).sum(0) + 1e-12,
        )
        np.testing.assert_array_less(
            np.abs(m2[i] - prods.sum(0)),
            64 * EPS32 * np.abs(prods).sum(0) + 1e-12,
        )
        assert cnt[i] == k


@pytest.mark.parametrize(
    "seed,n,k,cell",
    [(0, 4096, 15, 1.3), (0, 2000, 8, 1.4), (0, 1500, 5, 2.0),
     (1, 3000, 10, 1.2)],
)
def test_moments_certified_match_f64_brute(seed, n, k, cell):
    _check_certified(*_cloud(seed, n), k, cell, min_certified=n // 4)


def test_moments_georeferenced_match_f64_brute():
    """UTM-scale offsets: query-centred moments stay exact to f32 ulps of
    the local terms (coordinate differences, not absolute coordinates)."""
    xyz, valid = _cloud(3, 4096, offset=np.array([4.5e5, 1.2e5, 300.0]))
    _check_certified(xyz, valid, 15, 1.3, min_certified=1000)


def test_moments_duplicate_points_tie_flagged():
    """Exact duplicates put >k candidates at the kth distance: those rows
    must flag (cle > count), not silently pick an arbitrary subset."""
    rng = np.random.default_rng(7)
    base = rng.uniform(0, 5, (400, 3)).astype(np.float32)
    xyz = np.concatenate([base, base, base])  # every point tripled
    valid = np.ones(len(xyz), bool)
    k = 4
    m1, m2, cnt, ok = (
        np.asarray(x)
        for x in sweep_knn_moments(
            jnp.asarray(xyz), jnp.asarray(valid), np.float32(1.0), k=k,
        )
    )
    # With triplicated points the k=4 boundary usually falls inside a
    # duplicate group somewhere; every certified row must have an
    # unambiguous neighbor set. Cross-check certified rows against f64.
    fxyz = xyz.astype(np.float64)
    idx = np.nonzero(ok)[0]
    for i in idx[:: max(1, len(idx) // 50)]:
        d2 = ((fxyz - fxyz[i]) ** 2).sum(1)
        o = np.argsort(d2, kind="stable")
        kth = np.sort(d2)[k - 1]
        assert (d2 <= kth).sum() == k  # certified => tie-free
        rel = fxyz[o[:k]] - fxyz[i]
        np.testing.assert_allclose(m1[i], rel.sum(0), atol=2e-3)
