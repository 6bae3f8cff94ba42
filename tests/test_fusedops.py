"""Single-dispatch fused ops (ops/fusedops.py) against f64 oracles: sweep
pass 1 + in-graph exact rescue must reproduce scipy KD-tree answers at the
op-output level, on clouds whose sparse halo forces rows into the
rescue."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.spatial import cKDTree

from pointclouds_jax.core.cloud import make_cloud_arrays
from pointclouds_jax.ops import fusedops as fo
from pointclouds_jax.pipelines.parity import lexsorted_rows
from pointclouds_jax.spatial import engine

SEEDS = pytest.mark.parametrize("seed", [3, 4])


def _points(n=4096, seed=3):
    # Above BRUTE_THRESHOLD so the sweep path (not the small brute) runs;
    # mixed density so some rows actually get flagged and rescued.
    rng = np.random.default_rng(seed)
    pts = np.vstack([
        (rng.random((n - 32, 3)) * 8).astype(np.float32),
        # Mild sparse halo: flags a handful of rows into the rescue
        # without wrecking the global cell estimate.
        (rng.random((32, 3)) * 16 - 4).astype(np.float32),
    ])
    assert len(pts) > engine.BRUTE_THRESHOLD
    return pts


@SEEDS
def test_sor_fused_matches_f64_oracle(seed):
    pts = _points(seed=seed)
    arrs = make_cloud_arrays(pts)
    k, std_mul = 10, 1.5
    out, info = fo.sor_fused(
        arrs, jnp.float32(std_mul), k=k, wr=4,
        cap=fo.fused_rescue_cap(arrs.capacity),
    )
    info = np.asarray(info)
    assert info[1] == 1, "rescue cap overflowed; enlarge cap"
    p64 = pts.astype(np.float64)
    d, _ = cKDTree(p64).query(p64, k=k + 1)
    means = d[:, 1:].mean(axis=1)
    thr = means.mean() + std_mul * means.std()
    # f32 means sit within ~1e-6 relative of the f64 ones: rows that close
    # to the threshold may go either way.
    assert not (np.abs(means - thr) <= 1e-5 * thr).any()
    want = lexsorted_rows(pts[means <= thr])
    got = np.asarray(out.xyz)[np.asarray(out.valid)]
    assert info[0] == len(want) == len(got)
    np.testing.assert_array_equal(lexsorted_rows(got), want)


@SEEDS
def test_ror_fused_matches_f64_oracle(seed):
    pts = _points(seed=seed + 2)
    arrs = make_cloud_arrays(pts)
    r, m = 0.6, 4
    out, info = fo.ror_fused(
        arrs, jnp.float32(r), jnp.int32(m), wr=4,
        cap=fo.fused_rescue_cap(arrs.capacity),
    )
    info = np.asarray(info)
    assert info[1] == 1
    tree = cKDTree(pts.astype(np.float64))
    lo = tree.query_ball_point(pts, r * (1 - 1e-6), return_length=True)
    hi = tree.query_ball_point(pts, r * (1 + 1e-6), return_length=True)
    keep_lo, keep_hi = lo >= m, hi >= m  # count includes self
    assert (keep_lo == keep_hi).all(), "a point sits on the radius"
    got = np.asarray(out.xyz)[np.asarray(out.valid)]
    assert info[0] == keep_lo.sum() == len(got)
    np.testing.assert_array_equal(
        lexsorted_rows(got), lexsorted_rows(pts[keep_lo])
    )


@SEEDS
def test_normals_fused_matches_f64_oracle(seed):
    pts = _points(seed=seed + 4)
    arrs = make_cloud_arrays(pts)
    k = 10
    vp = np.array([0.0, 0.0, 100.0])
    nrm, exact = fo.normals_fused(
        arrs.xyz, arrs.valid, jnp.asarray(vp, jnp.float32), k=k, wr=4,
        cap=2048,  # headroom: the sparse halo flags many rows
    )
    assert int(np.asarray(exact)) == 1
    nrm = np.asarray(nrm)[: len(pts)]
    p64 = pts.astype(np.float64)
    _, idx = cKDTree(p64).query(p64, k=k)
    compared = 0
    for i in range(0, len(pts), 7):
        w, v = np.linalg.eigh(np.cov(p64[idx[i]].T, bias=True))
        gap = (w[1] - w[0]) / w[2]
        if gap < 0.05:
            continue  # smallest eigenvector ill-defined
        n64 = v[:, 0] if v[:, 0] @ (vp - p64[i]) >= 0 else -v[:, 0]
        # f32 Cardano resolves eigenvalues to ~sqrt(eps32) of the largest.
        limit = 8 * np.sqrt(np.finfo(np.float32).eps) / gap
        assert np.arccos(np.clip(n64 @ nrm[i], -1, 1)) <= limit, i
        compared += 1
    assert compared > 100


@SEEDS
def test_knn_fused_matches_f64_oracle(seed):
    pts = _points(seed=seed + 6)
    arrs = make_cloud_arrays(pts)
    k = 8
    d, i, nv, exact = fo.knn_fused(
        arrs.xyz, arrs.valid, k=k, wr=4,
        cap=2048,  # headroom: the sparse halo flags many rows
    )
    assert int(np.asarray(exact)) == 1
    n = len(pts)
    d, i, nv = (np.asarray(a)[:n] for a in (d, i, nv))
    assert nv.all()
    wd, wi = cKDTree(pts.astype(np.float64)).query(
        pts.astype(np.float64), k=k
    )
    np.testing.assert_allclose(d, wd, rtol=1e-5, atol=1e-5)
    # Indices may differ only at exact distance ties (none expected in
    # random data).
    assert (i == wi).mean() > 0.9999
