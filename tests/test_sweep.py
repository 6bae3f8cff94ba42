"""Differential tests for the sorted-window sweep SOR engine
(spatial/sweep.py) vs an f64 numpy brute-force oracle.

The sweep is certified-or-flagged like the block engine: every test checks
(a) certified rows are EXACT, and (b) flags are sound (a flagged row really
has its (k+1)-th neighbor beyond the certification radius, or sits in a
window-overflow / segment-certificate block — never silently wrong).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import pointclouds_jax  # noqa: F401
from pointclouds_jax.spatial.sweep import sweep_sor_mean_dists


# Each test runs on two data variants: the ``variant`` index offsets the
# scene's random seed.
VARIANTS = pytest.mark.parametrize("variant", [0, 1], ids=["data0", "data1"])


def brute_sor_means(pts, mask, k):
    """f64 oracle: mean distance to the k nearest neighbors (self-skip via
    k+1 extraction) of each valid finite point."""
    ok = mask & np.isfinite(pts).all(axis=1)
    idx = np.nonzero(ok)[0]
    P = pts[idx].astype(np.float64)
    out = np.full(len(pts), np.inf, np.float64)
    for i, p in zip(idx, P):
        d = np.sqrt(((P - p) ** 2).sum(axis=1))
        d.sort()
        sel = d[: k + 1]
        if len(sel) >= 2:
            out[i] = sel.sum() / (len(sel) - 1)
    return out


def _padded(pts, cap=None):
    n = len(pts)
    cap = cap or 1 << max(8, int(np.ceil(np.log2(max(n, 1)))))
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n] = pts
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return xyz, valid


def _check(xyz, valid, cell, k, min_certified_frac=0.0):
    mean, ok, cert = sweep_sor_mean_dists(
        jnp.asarray(xyz), jnp.asarray(valid), np.float32(cell), k=k,
    )
    mean = np.asarray(mean)
    ok = np.asarray(ok)
    expect = brute_sor_means(xyz, valid, k)
    np.testing.assert_allclose(mean[ok], expect[ok], rtol=1e-5, atol=1e-6)
    usable = valid & np.isfinite(xyz).all(axis=1)
    frac = ok.sum() / max(usable.sum(), 1)
    assert frac >= min_certified_frac, f"only {frac:.1%} certified"
    assert bool(cert) == bool(not np.any(usable & ~ok))
    return mean, ok


@VARIANTS
def test_sweep_uniform_exact(variant):
    rng = np.random.default_rng(0 + 100 * variant)
    xyz, valid = _padded((rng.random((3000, 3)) * 5).astype(np.float32))
    _check(xyz, valid, 0.8, 10, min_certified_frac=0.95)


@VARIANTS
def test_sweep_overlapping_windows_dedup(variant):
    # Tiny extent forces the 9 shift windows to overlap heavily; without
    # dedup masking, duplicated candidates double-count neighbors
    # (regression: the k-smallest over a MULTISET is not exact).
    rng = np.random.default_rng(1 + 100 * variant)
    xyz, valid = _padded((rng.random((600, 3)) * 2.0).astype(np.float32))
    _check(xyz, valid, 0.9, 8, min_certified_frac=0.5)


@VARIANTS
def test_sweep_mixed_density_flags_sound(variant):
    rng = np.random.default_rng(2 + 100 * variant)
    pts = np.vstack(
        [
            rng.random((1500, 3)) * 5,
            rng.normal([2, 2, 2], 0.1, (700, 3)),
            rng.random((800, 3)) * [20, 3, 1],
        ]
    ).astype(np.float32)
    xyz, valid = _padded(pts)
    _check(xyz, valid, 0.8, 10)


@VARIANTS
def test_sweep_georeferenced_offsets(variant):
    # UTM-easting-scale coordinates: differences stay exact in f32;
    # certificates must absorb the floor-rounding margin (ADVICE round-1
    # class of bug). At 4.5e5 m the margin is ~0.22 m < cell, so most rows
    # still certify; far bigger offsets would (correctly) flag everything.
    rng = np.random.default_rng(3 + 100 * variant)
    pts = (rng.random((2000, 3)) * 8).astype(np.float32) + np.float32(
        [4.5e5, 1.2e5, 300.0]
    )
    xyz, valid = _padded(pts)
    mean, ok = _check(xyz, valid, 1.5, 10)
    assert ok.sum() > 1000


@VARIANTS
def test_sweep_duplicate_points_ties(variant):
    # Exact duplicates create distance ties; extraction must count each
    # point once and equal values give equal sums either way.
    rng = np.random.default_rng(4 + 100 * variant)
    base = (rng.random((400, 3)) * 3).astype(np.float32)
    pts = np.vstack([base, base[:200]])
    xyz, valid = _padded(pts)
    _check(xyz, valid, 0.8, 6, min_certified_frac=0.9)


@VARIANTS
def test_sweep_invalid_and_nonfinite_rows(variant):
    rng = np.random.default_rng(5 + 100 * variant)
    xyz, valid = _padded((rng.random((1000, 3)) * 4).astype(np.float32))
    xyz[17] = np.nan  # valid-but-nonfinite: excluded
    valid[450] = False
    mean, ok = _check(xyz, valid, 0.8, 10, min_certified_frac=0.9)
    assert not ok[17] and not ok[450]
    assert np.isinf(mean[17]) and np.isinf(mean[450])


@VARIANTS
def test_sweep_k_exceeds_population(variant):
    rng = np.random.default_rng(6 + 100 * variant)
    xyz, valid = _padded((rng.random((12, 3)) * 0.2).astype(np.float32))
    mean, ok, cert = sweep_sor_mean_dists(
        jnp.asarray(xyz),
        jnp.asarray(valid),
        np.float32(1.0),
        k=20,
    )
    mean = np.asarray(mean)
    ok = np.asarray(ok)
    expect = brute_sor_means(xyz, valid, 20)
    # want = min(k+1, population): all 12 points resolve with 11 neighbors
    np.testing.assert_allclose(mean[ok], expect[ok], rtol=1e-5, atol=1e-6)
    assert ok[:12].all()


@VARIANTS
def test_sweep_all_invalid(variant):
    # data0: every row masked invalid; data1: every row valid but NaN.
    xyz = np.full((256, 3), np.nan if variant else 0.0, np.float32)
    valid = np.full(256, bool(variant))
    mean, ok, cert = sweep_sor_mean_dists(
        jnp.asarray(xyz),
        jnp.asarray(valid),
        np.float32(1.0),
        k=5,
    )
    assert not np.asarray(ok).any()
    assert np.isinf(np.asarray(mean)).all()


@VARIANTS
def test_sweep_knn_two_pass_rescues_flagged(variant):
    """The AABB-group-pruned rescue must certify (and exactly resolve)
    nearly every row pass 1 flags on a mixed-density cloud."""
    from pointclouds_jax.spatial import engine
    from pointclouds_jax.spatial.knn import bruteforce_knn
    from pointclouds_jax.spatial.sweep import sweep_knn, sweep_knn_two_pass

    rng = np.random.default_rng(0 + 100 * variant)
    pts = np.vstack([
        (rng.random((4000, 3)) * 8).astype(np.float32),
        (rng.random((96, 3)) * 16 - 4).astype(np.float32),
    ])
    import pointclouds_jax as pc

    c = pc.PointCloud.from_numpy(pts)
    xyz, valid = c._arrs.xyz, c._arrs.valid
    k = 10
    cell = jnp.float32(
        float(np.asarray(engine.estimate_cell_size(xyz, valid, k)))
    )
    d1, _, _, ok1 = sweep_knn(
        xyz, valid, cell, k=k, wr=4,
    )
    d2, i2, v2, ok2 = sweep_knn_two_pass(
        xyz, valid, cell, k=k, wr=4,
    )
    ok1, ok2 = np.asarray(ok1), np.asarray(ok2)
    assert ok2.sum() > ok1.sum()  # the rescue certified flagged rows
    assert ok2.sum() >= len(pts) - 8  # nearly everything certified

    bd, bi, bv = map(
        np.asarray, bruteforce_knn(xyz, valid, xyz, valid, k)
    )
    sel = ok2
    np.testing.assert_allclose(np.asarray(d2)[sel], bd[sel], atol=2e-5)
    mismatch = (np.asarray(i2)[sel] != bi[sel]) & np.asarray(v2)[sel]
    assert mismatch.mean() < 1e-3  # ties only


@VARIANTS
def test_sweep_radius_count_two_pass_rescues_overflow(variant):
    """A dense clump overflows the wr-row windows; the pruned rescue must
    resolve those rows exactly (no certificate needed — the prune ball is
    the query radius)."""
    from pointclouds_jax.spatial.knn import bruteforce_radius_count
    from pointclouds_jax.spatial.sweep import (
        sweep_radius_count,
        sweep_radius_count_two_pass,
    )

    rng = np.random.default_rng(2 + 100 * variant)
    pts = np.vstack([
        (rng.random((3000, 3)) * 10).astype(np.float32),
        # Dense clump: ~1100 points inside one radius ball.
        (rng.random((1096, 3)) * 0.4 + 5.0).astype(np.float32),
    ])
    import pointclouds_jax as pc

    c = pc.PointCloud.from_numpy(pts)
    xyz, valid = c._arrs.xyz, c._arrs.valid
    r = np.float32(0.5)
    c1, ok1 = sweep_radius_count(
        xyz, valid, r, wr=4,
    )
    c2, ok2 = sweep_radius_count_two_pass(
        xyz, valid, r, wr=4,
    )
    ok1, ok2 = np.asarray(ok1), np.asarray(ok2)
    assert ok1.sum() < len(pts)  # the clump genuinely overflowed windows
    assert ok2.sum() == len(pts)  # ...and the rescue resolved every row

    ref = np.asarray(
        bruteforce_radius_count(xyz, valid, xyz, valid, r)
    )
    sel = np.asarray(valid)
    np.testing.assert_array_equal(np.asarray(c2)[sel], ref[sel])


def test_two_pass_fix_cap_rounds_to_block_multiple():
    """fix_cap not divisible by 128 must be accepted (rounded up to the
    query-block size internally), not raise an obscure reshape error."""
    from pointclouds_jax.spatial import engine
    from pointclouds_jax.spatial.sweep import sweep_knn_two_pass

    rng = np.random.default_rng(5)
    pts = (rng.random((3000, 3)) * 6).astype(np.float32)
    import pointclouds_jax as pc

    c = pc.PointCloud.from_numpy(pts)
    xyz, valid = c._arrs.xyz, c._arrs.valid
    cell = jnp.float32(
        float(np.asarray(engine.estimate_cell_size(xyz, valid, 8)))
    )
    d, i, v, ok = sweep_knn_two_pass(
        xyz, valid, cell, k=8, wr=4, fix_cap=1000
    )
    assert np.asarray(ok).sum() > 0


@VARIANTS
def test_per_query_coverage_certificate_exact_and_wider(variant):
    """The per-query coverage-radius certificate (structure_from_sorted
    with grid_origin): certified rows must still be EXACT vs brute
    force, and the certified fraction must strictly beat the worst-case
    one-cell-width certificate on a workload whose kth distance sits
    right at the cell width (the KITTI k=20 regime)."""
    from pointclouds_jax.ops.filters import voxel_downsample_sweep_fused
    from pointclouds_jax.spatial.sweep import (
        structure_from_sorted,
        sweep_sor_two_pass,
    )

    rng = np.random.default_rng(11 + 100 * variant)
    # density tuned so the k=10 radius ~ the 3-voxel cell width
    pts = (rng.random((6000, 3)) * [30.0, 30.0, 1.5]).astype(np.float32)
    xyz, valid = _padded(pts, cap=8192)
    voxel = np.float32(0.35)
    factor = 3
    fe = voxel_downsample_sweep_fused(
        jnp.asarray(xyz), jnp.asarray(valid), voxel, factor=factor,
        ds_cap=8192,
    )
    cents = np.asarray(fe["centroids"])
    cvalid = np.asarray(fe["out_valid"])

    def run(origin):
        prebuilt = structure_from_sorted(
            fe["centroids"], fe["out_valid"], fe["slin"], fe["extent"],
            fe["hi_cells"], fe["table_overflow"], wr=4,
            grid_origin=origin,
        )
        mean, ok, _ = sweep_sor_two_pass(
            fe["centroids"], fe["out_valid"], voxel * factor, k=10,
            rescue_cells=2.0, per_seg=2, prebuilt=prebuilt,
            fix_cap=256,
        )
        return np.asarray(mean), np.asarray(ok)

    mean_w, ok_w = run((fe["mn_v"], voxel, factor))
    mean_0, ok_0 = run(None)
    expect = brute_sor_means(cents, cvalid, 10)
    # Exactness of every certified row under BOTH certificates.
    np.testing.assert_allclose(mean_w[ok_w], expect[ok_w], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(mean_0[ok_0], expect[ok_0], rtol=1e-5,
                               atol=1e-6)
    # The per-query radius must certify strictly more (the effect is
    # larger pre-rescue; post-rescue this scene keeps a ~10% edge).
    assert ok_w.sum() > ok_0.sum() * 1.05, (ok_w.sum(), ok_0.sum())


@VARIANTS
def test_sor_lower_bound_sound(variant):
    """The decision-certificate lower bound must really bound the TRUE
    mean neighbor distance from below (and the returned mean from above)
    for every valid row — on a mixed-density scene with isolated points,
    clusters, and a sparse band, against an f64 brute-force oracle."""
    from pointclouds_jax.ops.filters import voxel_downsample_sweep_fused
    from pointclouds_jax.spatial.sweep import (
        structure_from_sorted,
        sweep_sor_two_pass,
    )

    rng = np.random.default_rng(23 + 100 * variant)
    pts = np.vstack([
        (rng.random((4000, 3)) * [25.0, 25.0, 2.0]).astype(np.float32),
        # isolated far points (the rows the old certificate could never
        # certify)
        (rng.random((20, 3)) * 200.0 + 50.0).astype(np.float32),
        # a tight clump
        (rng.random((500, 3)) * 0.5 + 10.0).astype(np.float32),
    ])
    xyz, valid = _padded(pts, cap=8192)
    voxel = np.float32(0.4)
    k = 12
    fe = voxel_downsample_sweep_fused(
        jnp.asarray(xyz), jnp.asarray(valid), voxel, factor=3, ds_cap=8192,
    )
    prebuilt = structure_from_sorted(
        fe["centroids"], fe["out_valid"], fe["slin"], fe["extent"],
        fe["hi_cells"], fe["table_overflow"], wr=4,
        grid_origin=(fe["mn_v"], voxel, 3),
    )
    mean, ok, _, lb = sweep_sor_two_pass(
        fe["centroids"], fe["out_valid"], voxel * 3, k=k,
        rescue_cells=8.0, per_seg=2, prebuilt=prebuilt,
        fix_cap=1024, with_lb=True,
    )
    cents = np.asarray(fe["centroids"])
    cvalid = np.asarray(fe["out_valid"])
    mean = np.asarray(mean)
    lb = np.asarray(lb)
    ok = np.asarray(ok)
    true_mean = brute_sor_means(cents, cvalid, k)
    v = cvalid
    # LB soundness (small f32 slack): lb <= true mean everywhere.
    assert (lb[v] <= true_mean[v] * (1 + 1e-4) + 1e-4).all(), (
        np.max(lb[v] - true_mean[v])
    )
    # UB soundness: finite returned means never undershoot the truth.
    fin = v & np.isfinite(mean)
    assert (mean[fin] >= true_mean[fin] * (1 - 1e-4) - 1e-4).all()
    # Exact rows: lb == mean == truth.
    np.testing.assert_allclose(mean[ok & v], true_mean[ok & v],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lb[ok & v], mean[ok & v], rtol=1e-6,
                               atol=1e-6)
    # The bound must be non-trivial for the isolated points (all of them
    # provably far: lb well above the clump scale).
    assert (lb[v] > 1.0).sum() >= 15
