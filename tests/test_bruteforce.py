"""Tiled brute-force KNN and radius count (spatial/knn.py) — the exact
rescue paths of every fused op — against an f64 numpy oracle, with
invalid rows on both sides."""

import numpy as np
import jax.numpy as jnp
import pytest

from pointclouds_jax.spatial.knn import (
    bruteforce_knn,
    bruteforce_radius_count,
)


def _pair(seed, n_q, n_p):
    rng = np.random.default_rng(seed)
    q = (rng.random((n_q, 3)) * 10).astype(np.float32)
    p = (rng.random((n_p, 3)) * 10).astype(np.float32)
    return q, p, rng.random(n_q) > 0.1, rng.random(n_p) > 0.1


@pytest.mark.parametrize(
    "n_q,n_p,k", [(300, 500, 5), (128, 128, 3), (7, 1000, 11), (257, 950, 10)]
)
def test_bruteforce_knn_matches_f64(n_q, n_p, k):
    q, p, qu, pu = _pair(0, n_q, n_p)
    d, idx, nv = map(
        np.asarray,
        bruteforce_knn(jnp.asarray(p), jnp.asarray(pu), jnp.asarray(q),
                       jnp.asarray(qu), k),
    )
    d2 = ((q[:, None, :].astype(np.float64) - p[None, :, :]) ** 2).sum(-1)
    d2[:, ~pu] = np.inf
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    want = np.sqrt(np.take_along_axis(d2, order, axis=1))
    assert not nv[~qu].any()
    assert (nv[qu] == np.isfinite(want[qu])).all()
    np.testing.assert_allclose(d[qu][nv[qu]], want[qu][nv[qu]], rtol=1e-5,
                               atol=1e-5)
    # Index mismatches only possible at exact float ties (none in random
    # data).
    assert (idx[qu] == order[qu])[nv[qu]].all()


def test_bruteforce_radius_count_matches_f64():
    q, p, qu, pu = _pair(1, 300, 900)
    r = 1.2
    counts = np.asarray(
        bruteforce_radius_count(jnp.asarray(p), jnp.asarray(pu),
                                jnp.asarray(q), jnp.asarray(qu),
                                np.float32(r))
    )
    d = np.sqrt(((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1))
    d[:, ~pu] = np.inf
    # f32 vs f64 distances may disagree only within a few ulps of r.
    lo = (d <= r * (1 - 1e-6)).sum(1)
    hi = (d <= r * (1 + 1e-6)).sum(1)
    assert ((counts[qu] >= lo[qu]) & (counts[qu] <= hi[qu])).all()
    assert (lo[qu] == hi[qu]).mean() > 0.99
    assert (counts[~qu] == 0).all()
