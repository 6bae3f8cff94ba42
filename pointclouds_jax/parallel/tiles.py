"""Spatial-tile points-axis sharding with explicit halo exchange.

GSPMD point-sharding of the fused pipelines drags every cell-id sort
through distributed-sort collective chains (DISTRIBUTED.md: 1.4-5x
per-frame COST at points=2/4). This module implements SURVEY §5.8's
actual design — shard each frame's points by spatial x-slabs aligned to
sor-cell boundaries — with `shard_map` and four explicit collectives:

1. ROUTE: one `all_to_all` sends every raw point to the tile that owns
   its sor-cell x column. Each device then sorts only its own slab, so
   the dominant cell-id sorts shrink ~P-fold (GSPMD's distributed sort
   kept the full n on the critical path AND added collectives per pass).
2. TILE-LOCAL VOXEL DOWNSAMPLE on the GLOBAL voxel lattice (`pmin`/
   `pmax` of the cell bounds). Tile boundaries are whole sor cells and
   the sor cell is a whole multiple of the voxel, so no voxel straddles
   tiles: per-voxel sums see exactly the same members in the same
   canonical order as the unsharded op — centroids match to within one
   ULP (the `associative_scan` combine tree depends on the voxel's
   array offset, which shifts per tile; members and order don't).
3. HALO: `ppermute` exchanges the boundary slab (``halo_cells`` sor
   cells deep — the SOR rescue reach) with each x neighbor, so the
   tile-local SOR sees every candidate the unsharded SOR would for the
   rows it owns. Mean distances for owned rows are exactly the
   unsharded values; the keep threshold folds tile sums with `psum`.
4. TAIL: the cleaned centroid set (small — ~1/8 the raw frame) is
   `all_gather`'d and RANSAC + obstacle compaction + clustering run
   REPLICATED on every device: the tail is a global decision (one
   plane, one label set) whose compute is a minority of the frame, and
   replication costs zero further collectives.

Parity contract (round 5, bit-stable): voxel centroids ULP-equal (see
above); SOR candidate sets for owned rows identical to the unsharded
sweep's; the keep threshold is accumulated in f64 on BOTH sides (order-
insensitive to ~1e-16 relative, matching `sor_keep_mask`); and RANSAC
rebuilds the unsharded pipeline's canonical position_rows from the
gathered global voxel keys, so hypothesis/tournament selection is
bit-identical whenever the cleaned sets and centroid bits agree.
Cleaned/cluster outputs are asserted geometrically equal in
tests/test_tiles.py (row order still differs — tile-major gather).

Ref for the scaling target this replaces: the reference's rayon
intra-process parallelism (SURVEY.md C22); measured GSPMD failure:
DISTRIBUTED.md.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.filters import sor_keep_mask, voxel_scan_sor_epilogue
from ..ops.segmentation import ransac_plane_masked
from ..spatial.grid import cell_coords
from ..spatial.sweep import (
    structure_from_sorted,
    sweep_cluster_labels,
    sweep_sor_two_pass,
)

_INVALID32 = jnp.int32(2**31 - 1)


def _round128(v: int) -> int:
    return max(((int(v) + 127) // 128) * 128, 128)


class TiledKittiOutput(NamedTuple):
    plane_normal: jax.Array  # f32[B, 3]
    plane_d: jax.Array  # f32[B]
    centroids: jax.Array  # f32[B, P*DCAP, 3] gathered, tile-major order
    downsampled_valid: jax.Array  # bool[B, P*DCAP]
    cleaned_valid: jax.Array  # bool[B, P*DCAP] after SOR
    obstacle_xyz: jax.Array  # f32[B, CAP, 3] (tile-major gathered order)
    obstacle_valid: jax.Array  # bool[B, CAP]
    labels: jax.Array  # i32[B, CAP] cluster labels over obstacle slots
    cleaned_count: jax.Array  # i32[B]
    sor_certified: jax.Array  # bool[B]
    cluster_exact: jax.Array  # bool[B]
    flags: jax.Array  # bool[B, 4]: route/ds/halo overflow, obstacle ovf


def _route_to_tiles(ckey, x, y, z, use, ext_v, esc, *, p: int,
                    factor: int, pair_cap: int):
    """Quantile route + all_to_all + local merge shared by the tiled
    pipelines. Returns (mkey, mx, my, mz, route_overflow, lo_t, hi_t):
    this tile's merged, canonically sorted rows plus its owned sor-x
    column range [lo_t, hi_t)."""
    t = jax.lax.axis_index("points")
    if p == 1:
        # Single-tile fast path: no routing, no halos — ONE canonical
        # sort IS the merged frame (no route sort, re-"merge" sort or halo
        # machinery at points=1).
        mkey, mx_, my_, mz_ = jax.lax.sort(
            (ckey, x, y, z), num_keys=1, is_stable=True
        )
        return (mkey, mx_, my_, mz_, jnp.asarray(False), jnp.int32(0),
                jnp.maximum(esc[0], 1))

    # ── ROUTE: all_to_all by owning tile of the sor-x column ──
    # QUANTILE boundaries: tiles own equal point COUNTS, not equal x
    # spans (KITTI frames are center-heavy — uniform spans left the
    # middle tiles ~1.6x overloaded, forcing fat static caps). A psum'd
    # histogram over binned sor-x columns gives the global cdf; a tile
    # owns the bins whose cdf prefix lands in its count quantile. Whole
    # sor-x columns map to one bin, so tile boundaries stay aligned to
    # sor cells (and therefore to whole voxels).
    nbins = 2048
    esc0 = jnp.maximum(esc[0], 1)
    eyz_v = jnp.maximum(ext_v[1] * ext_v[2], 1)

    def bin_of(keys):
        r0 = keys // eyz_v
        return jnp.clip(
            ((r0 // factor).astype(jnp.int64) * nbins
             // esc0.astype(jnp.int64)).astype(jnp.int32),
            0,
            nbins - 1,
        )

    binof = bin_of(ckey)
    hist = jnp.zeros((nbins,), jnp.int32).at[
        jnp.where(use, binof, nbins - 1)
    ].add(jnp.where(use, 1, 0))
    hist = jax.lax.psum(hist, "points")
    cdf_ex = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(hist)[:-1]]
    )
    total = jnp.maximum(jnp.sum(hist), 1)
    dest_of_bin = jnp.clip(
        (cdf_ex.astype(jnp.int64) * p // total.astype(jnp.int64)).astype(
            jnp.int32
        ),
        0,
        p - 1,
    )  # monotone in bin
    # Tile sor-x bounds (for the halo membership tests below): my first
    # owned bin = #bins owned by smaller tiles; bin b covers sor-x
    # [ceil(b*esc0/nbins), ...) by the binof mapping above.
    lo_bin = jnp.sum((dest_of_bin < t).astype(jnp.int32))
    hi_bin = jnp.sum((dest_of_bin <= t).astype(jnp.int32))
    lo_t = -((-lo_bin.astype(jnp.int64) * esc0.astype(jnp.int64)) // nbins)
    lo_t = lo_t.astype(jnp.int32)
    hi_t = -((-hi_bin.astype(jnp.int64) * esc0.astype(jnp.int64)) // nbins)
    hi_t = hi_t.astype(jnp.int32)
    # ONE stable 1-key sort both groups rows by destination and orders
    # each group canonically: dest is a NON-DECREASING function of the
    # sor-x column (quantile cut points are monotone in bin, bin in
    # sor-x), and ckey orders by r0 = voxel-x first, so ascending ckey
    # already implies ascending dest — the v1 2-key (dest, ckey) sort
    # paid a 5th full-n channel for nothing. Ties keep ascending-
    # original-row order (the canonical combine-tree order — bitwise
    # centroid parity). sdest is recomputed elementwise from the sorted
    # keys.
    skey, sx, sy, sz = jax.lax.sort(
        (ckey, x, y, z), num_keys=1, is_stable=True
    )
    sdest = jnp.where(
        skey != _INVALID32, jnp.take(dest_of_bin, bin_of(skey)), jnp.int32(p)
    )
    cnt = jnp.sum(
        (sdest[None, :] == jnp.arange(p, dtype=jnp.int32)[:, None]).astype(
            jnp.int32
        ),
        axis=1,
    )  # [P] rows per destination
    off = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(cnt)[:-1]]
    )
    # pair_cap bounds the rows one SOURCE device may send one TILE
    # (expected n/P^2 on balanced scenes; overflow is flagged).
    route_overflow = jnp.any(cnt > pair_cap)
    slot = jnp.arange(p * pair_cap, dtype=jnp.int32)
    d_of = slot // pair_cap
    i_of = slot % pair_cap
    src = jnp.take(off, d_of) + i_of
    in_seg = i_of < jnp.take(cnt, d_of)
    src = jnp.where(in_seg, jnp.minimum(src, sdest.shape[0] - 1), 0)
    send_key = jnp.where(in_seg, jnp.take(skey, src), _INVALID32)
    send_xyz = jnp.stack(
        [
            jnp.where(in_seg, jnp.take(sx, src), 0.0),
            jnp.where(in_seg, jnp.take(sy, src), 0.0),
            jnp.where(in_seg, jnp.take(sz, src), 0.0),
        ],
        axis=1,
    )
    rkey = jax.lax.all_to_all(
        send_key, "points", split_axis=0, concat_axis=0, tiled=True
    )
    rxyz = jax.lax.all_to_all(
        send_xyz, "points", split_axis=0, concat_axis=0, tiled=True
    )
    # Merge the P received (already sorted) segments: one local sort of
    # ~tile-sized rows — the tiled replacement for the unsharded "sort 1".
    mkey, mx_, my_, mz_ = jax.lax.sort(
        (rkey, rxyz[:, 0], rxyz[:, 1], rxyz[:, 2]),
        num_keys=1,
        is_stable=True,
    )
    return mkey, mx_, my_, mz_, route_overflow, lo_t, hi_t


def _tiled_frame(xyz, valid, voxel, sor_std, ransac_thresh, seed,
                 cluster_r, *, p: int, factor: int, sor_k: int,
                 ransac_iters: int, ransac_subsample, obstacle_cap: int,
                 pair_cap: int, ds_tile_cap: int, halo_cap: int,
                 halo_cells: int, table_size: int):
    """One frame on one tile (runs under shard_map over the ``points``
    axis; ``xyz`` is this device's raw row shard [n/P, 3])."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    finite = jnp.isfinite(x) & jnp.isfinite(y) & jnp.isfinite(z)
    use = jnp.logical_and(valid, finite)

    # ── Global voxel lattice (pmin/pmax over tiles) ──
    c = cell_coords(xyz, voxel)
    big32 = jnp.int32(2**30)
    mn_loc = jnp.min(jnp.where(use[:, None], c, big32), axis=0)
    mn_v = jnp.minimum(jax.lax.pmin(mn_loc, "points"), big32 - 1)
    rel = jnp.clip(c - mn_v[None, :], 0, None)
    mx_loc = jnp.max(jnp.where(use[:, None], rel, 0), axis=0)
    mx_rel = jax.lax.pmax(mx_loc, "points")
    ext_v = mx_rel + 1
    ext64 = ext_v.astype(jnp.int64)
    esc = mx_rel // factor + 1  # global sor-grid extent
    esc64 = esc.astype(jnp.int64)
    table_overflow = jnp.logical_or(
        (esc64[0] * esc64[1] * esc64[2]) > table_size,
        (ext64[0] * ext64[1] * ext64[2]) > 2**31 - 2,
    )

    ckey64 = (rel[:, 0].astype(jnp.int64) * ext64[1] + rel[:, 1]) * ext64[
        2
    ] + rel[:, 2]
    ckey = jnp.where(
        use, jnp.clip(ckey64, 0, 2**31 - 2).astype(jnp.int32), _INVALID32
    )

    mkey, mx_, my_, mz_, route_overflow, lo_t, hi_t = _route_to_tiles(
        ckey, x, y, z, use, ext_v, esc, p=p, factor=factor,
        pair_cap=pair_cap,
    )
    return _tiled_frame_tail(
        mkey, mx_, my_, mz_, route_overflow, lo_t, hi_t, mn_v, ext_v,
        esc, table_overflow, voxel, sor_std, ransac_thresh, seed,
        cluster_r, p=p, factor=factor, sor_k=sor_k,
        ransac_iters=ransac_iters, ransac_subsample=ransac_subsample,
        obstacle_cap=obstacle_cap, ds_tile_cap=ds_tile_cap,
        halo_cap=halo_cap, halo_cells=halo_cells,
        table_size=table_size,
    )


def _halo_merge(centroids, ds_valid, slin, esc, lo_t, hi_t, *, p: int,
                halo_cells: int, halo_cap: int, ds_tile_cap: int,
                table_size: int):
    """Exchange ``halo_cells``-deep boundary sor-cell slabs with the x
    neighbors and merge (left halo | own | right halo) keeping global
    sort order. Returns (m_xyz, m_valid, m_slin, nli, halo_overflow):
    merged rows (own rows start at ``nli``) for a prebuilt sweep
    structure whose owned-row results match the unsharded op's.

    Shared by the tiled KITTI (SOR halos) and aerial (normals
    halos) pipelines."""
    eyz = jnp.maximum(esc[1], 1) * jnp.maximum(esc[2], 1)
    row_sx = jnp.where(ds_valid, slin // eyz, _INVALID32)
    nown = jnp.sum(ds_valid.astype(jnp.int32))
    h = jnp.int32(halo_cells)

    # Rows for the LEFT neighbor: sor-x < lo_t + h — an ascending PREFIX.
    cl = jnp.sum(
        jnp.logical_and(ds_valid, row_sx < lo_t + h).astype(jnp.int32)
    )
    left_overflow = cl > halo_cap
    lslot = jnp.arange(halo_cap, dtype=jnp.int32)
    lvalid = lslot < jnp.minimum(cl, halo_cap)
    lkey = jnp.where(lvalid, slin[:halo_cap], jnp.int32(table_size))
    lx = jnp.where(lvalid, centroids[:halo_cap, 0], 0.0)
    ly = jnp.where(lvalid, centroids[:halo_cap, 1], 0.0)
    lz = jnp.where(lvalid, centroids[:halo_cap, 2], 0.0)

    # Rows for the RIGHT neighbor: sor-x >= hi_t - h — a SUFFIX of the
    # valid region; dynamic_slice front-aligns it.
    cr = jnp.sum(
        jnp.logical_and(ds_valid, row_sx >= hi_t - h).astype(jnp.int32)
    )
    right_overflow = cr > halo_cap
    rstart = jnp.clip(nown - cr, 0, ds_tile_cap - 1).astype(jnp.int32)
    rs = jnp.minimum(rstart, ds_tile_cap - halo_cap).astype(jnp.int32)
    rrows = jax.lax.dynamic_slice(slin, (rs,), (halo_cap,))
    rxyz_s = jax.lax.dynamic_slice(
        centroids, (rs, jnp.int32(0)), (halo_cap, 3)
    )
    roff = rstart - rs  # qualifying run starts here within the slice
    rslot = jnp.arange(halo_cap, dtype=jnp.int32)
    rvalid = jnp.logical_and(
        rslot >= roff, rslot < roff + jnp.minimum(cr, halo_cap)
    )
    # Front-align: qualifying rows occupy [roff, roff+cr) — shift down.
    rsel = jnp.minimum(rslot + roff, halo_cap - 1)
    rvalid_f = jnp.take(rvalid, rsel)
    rkey_h = jnp.where(rvalid_f, jnp.take(rrows, rsel), jnp.int32(table_size))
    rx_h = jnp.where(rvalid_f, jnp.take(rxyz_s[:, 0], rsel), 0.0)
    ry_h = jnp.where(rvalid_f, jnp.take(rxyz_s[:, 1], rsel), 0.0)
    rz_h = jnp.where(rvalid_f, jnp.take(rxyz_s[:, 2], rsel), 0.0)

    right_perm = [(i, i + 1) for i in range(p - 1)]  # send right
    left_perm = [(i, i - 1) for i in range(1, p)]  # send left

    def pperm(v, perm):
        return jax.lax.ppermute(v, "points", perm)

    # Validity rides its own f32 channel: ppermute zero-fills devices
    # with no source, so v=0 marks both "no neighbor" and pad slots (a
    # key-based test would mis-treat legitimate sor cell id 0).
    rv_h = rvalid_f.astype(jnp.float32)
    lv_h = lvalid.astype(jnp.float32)
    # left_in: the LEFT neighbor's right-going slab (ids all < mine).
    li_key, li_x, li_y, li_z, li_vf = (
        pperm(v, right_perm) for v in (rkey_h, rx_h, ry_h, rz_h, rv_h)
    )
    ri_key, ri_x, ri_y, ri_z, ri_vf = (
        pperm(v, left_perm) for v in (lkey, lx, ly, lz, lv_h)
    )
    li_v = li_vf > 0.5
    ri_v = ri_vf > 0.5
    li_key = jnp.where(li_v, li_key, jnp.int32(table_size))
    ri_key = jnp.where(ri_v, ri_key, jnp.int32(table_size))
    nli = jnp.sum(li_v.astype(jnp.int32))
    nri = jnp.sum(ri_v.astype(jnp.int32))

    # ── Merge (left halo | own | right halo) — still globally sorted ──
    mcap = halo_cap + ds_tile_cap + halo_cap
    j = jnp.arange(mcap, dtype=jnp.int32)
    nm = nli + nown + nri
    src_m = jnp.where(
        j < nli,
        j,
        jnp.where(
            j < nli + nown,
            halo_cap + (j - nli),
            halo_cap + ds_tile_cap + jnp.clip(j - nli - nown, 0, halo_cap - 1),
        ),
    )
    src_m = jnp.where(j < nm, src_m, 0)
    mvalid = j < nm

    def cat(a, b, c3):
        return jnp.concatenate([a, b, c3])

    all_key = cat(li_key, jnp.where(ds_valid, slin, jnp.int32(table_size)),
                  ri_key)
    all_x = cat(li_x, centroids[:, 0], ri_x)
    all_y = cat(li_y, centroids[:, 1], ri_y)
    all_z = cat(li_z, centroids[:, 2], ri_z)
    m_slin = jnp.where(mvalid, jnp.take(all_key, src_m), jnp.int32(table_size))
    m_xyz = jnp.stack(
        [
            jnp.where(mvalid, jnp.take(all_x, src_m), 0.0),
            jnp.where(mvalid, jnp.take(all_y, src_m), 0.0),
            jnp.where(mvalid, jnp.take(all_z, src_m), 0.0),
        ],
        axis=1,
    )
    m_valid = jnp.logical_and(mvalid, m_slin < table_size)

    return (m_xyz, m_valid, m_slin, nli,
            jnp.logical_or(left_overflow, right_overflow))


def _tiled_frame_tail(mkey, mx_, my_, mz_, route_overflow, lo_t, hi_t,
                      mn_v, ext_v, esc, table_overflow, voxel, sor_std,
                      ransac_thresh, seed, cluster_r, *, p: int,
                      factor: int, sor_k: int, ransac_iters: int,
                      ransac_subsample, obstacle_cap: int,
                      ds_tile_cap: int, halo_cap: int, halo_cells: int,
                      table_size: int):
    """Everything downstream of the route/merge: tile-local voxel
    epilogue, halo exchange, SOR, psum'd keep threshold, replicated
    tail. Split out so the p == 1 fast path can skip routing."""
    # ── Tile-local voxel downsample (global lattice) ──
    ep = voxel_scan_sor_epilogue(
        mkey, mx_, my_, mz_, ext_v, esc, factor=factor,
        ds_cap=ds_tile_cap, table_size=table_size,
    )
    centroids, ds_valid = ep["centroids"], ep["out_valid"]
    slin, canon = ep["slin"], ep["canon"]
    ds_overflow = ep["ds_overflow"]

    # ── HALO exchange + merge (shared helper) ──
    m_xyz, m_valid, m_slin, nli, halo_ovf = _halo_merge(
        centroids, ds_valid, slin, esc, lo_t, hi_t, p=p,
        halo_cells=halo_cells, halo_cap=halo_cap,
        ds_tile_cap=ds_tile_cap, table_size=table_size,
    )

    # ── Tile-local SOR (prebuilt structure on the merged sorted frame) ──
    hi_v = jnp.max(
        jnp.maximum(jnp.abs(mn_v), jnp.abs(mn_v + ext_v)).astype(jnp.float32)
    )
    hi_cells = (hi_v + float(factor)) / float(factor)
    prebuilt = structure_from_sorted(
        m_xyz, m_valid, m_slin, esc, hi_cells, table_overflow, wr=4,
        table_size=table_size, grid_origin=(mn_v, voxel, factor),
    )
    sor_cell = voxel * float(factor)
    means_m, ok_m, _, lb_m = sweep_sor_two_pass(
        m_xyz, m_valid, sor_cell, k=sor_k, rescue_cells=float(halo_cells),
        per_seg=2, prebuilt=prebuilt, with_lb=True,
    )
    means = jax.lax.dynamic_slice(means_m, (nli,), (ds_tile_cap,))
    ok_own = jax.lax.dynamic_slice(ok_m, (nli,), (ds_tile_cap,))
    lb_own = jax.lax.dynamic_slice(lb_m, (nli,), (ds_tile_cap,))

    # Global keep threshold: psum'd mean/variance of finite mean dists.
    # f64 partials (matching sor_keep_mask's f64 accumulation) make the
    # threshold order-insensitive to ~1e-16 relative — bit-stable keep
    # decisions vs the unsharded pipeline for any mean_dist not within
    # ~1e-16 of the threshold.
    fin = jnp.logical_and(ds_valid, jnp.isfinite(means))
    m64 = means.astype(jnp.float64)
    s0 = jax.lax.psum(jnp.sum(fin.astype(jnp.float64)), "points")
    s1 = jax.lax.psum(jnp.sum(jnp.where(fin, m64, 0.0)), "points")
    n0 = jnp.maximum(s0, 1.0)
    gmean = s1 / n0
    s2 = jax.lax.psum(
        jnp.sum(jnp.where(fin, (m64 - gmean) ** 2, 0.0)), "points"
    )
    thr = gmean + sor_std.astype(jnp.float64) * jnp.sqrt(s2 / n0)
    keep = jnp.logical_and(ds_valid, m64 <= thr)
    # Keep-DECISION certificate (same argument as pipelines/kitti.py):
    # exact mean, OR upper-bound mean already keeps, OR proven lower
    # bound exceeds the threshold (removal certified).
    decision_ok = jnp.logical_or(
        jnp.logical_or(ok_own, keep), lb_own.astype(jnp.float64) > thr
    )
    cert_loc = jnp.logical_and(
        jnp.all(jnp.logical_or(decision_ok, jnp.logical_not(ds_valid))),
        jnp.logical_not(table_overflow),
    )
    sor_certified = jax.lax.pmin(cert_loc.astype(jnp.int32), "points") > 0

    # ── TAIL (replicated): gather cleaned centroids, RANSAC + cluster ──
    g_xyz = jax.lax.all_gather(centroids, "points", axis=0, tiled=True)
    g_keep = jax.lax.all_gather(keep, "points", axis=0, tiled=True)
    # Canonical-order position map (the unsharded pipeline's RANSAC
    # mini-sort, pipelines/kitti.py): position p -> the row of the p-th
    # cleaned centroid in CANONICAL voxel-key order. The canon key lives
    # on the GLOBAL lattice (mn_v/ext_v are pmin/pmax'd), so sorting the
    # gathered tile-major array by it reproduces the exact hypothesis
    # (and tournament-subsample) selection of the unsharded run —
    # tiled/unsharded planes are bit-identical whenever the cleaned sets
    # and centroid bits agree.
    g_canon = jax.lax.all_gather(
        jnp.where(ds_valid, canon, _INVALID32), "points", axis=0, tiled=True
    )
    gkey = jnp.where(g_keep, g_canon, _INVALID32)
    _, position_rows = jax.lax.sort(
        (gkey, jnp.arange(gkey.shape[0], dtype=jnp.int32)),
        num_keys=1,
        is_stable=True,
    )
    normal, d, inlier = ransac_plane_masked(
        g_xyz, g_keep, ransac_thresh, seed, ransac_iters,
        score_subsample=ransac_subsample,
        # Match the unsharded pipeline's reference-dispatch rule so both
        # paths pick the same winner at any cleaned count (under the
        # frame vmap the lax.cond becomes a select; the tail is small).
        adaptive=(ransac_subsample is None),
        position_rows=position_rows,
    )
    obstacle = jnp.logical_and(g_keep, jnp.logical_not(inlier))
    from ..core.cloud import compaction_order

    order = compaction_order(obstacle)
    obs_src = order[:obstacle_cap].astype(jnp.int32)
    obs_valid = jnp.take(obstacle, obs_src)
    obs_xyz = jnp.take(g_xyz, obs_src, axis=0)
    n_obstacle = jnp.sum(obstacle.astype(jnp.int32))
    obs_overflow = n_obstacle > obstacle_cap
    labels, cluster_exact = sweep_cluster_labels(
        obs_xyz, obs_valid, cluster_r, wr=12
    )

    flags = jnp.stack(
        [
            jax.lax.pmax(route_overflow.astype(jnp.int32), "points") > 0,
            jax.lax.pmax(ds_overflow.astype(jnp.int32), "points") > 0,
            jax.lax.pmax(halo_ovf.astype(jnp.int32), "points") > 0,
            obs_overflow,
        ]
    )
    cleaned_count = jax.lax.psum(jnp.sum(keep.astype(jnp.int32)), "points")
    g_valid = jax.lax.all_gather(ds_valid, "points", axis=0, tiled=True)
    return TiledKittiOutput(
        plane_normal=normal,
        plane_d=d,
        centroids=g_xyz,
        downsampled_valid=g_valid,
        cleaned_valid=g_keep,
        obstacle_xyz=obs_xyz,
        obstacle_valid=obs_valid,
        labels=labels,
        cleaned_count=cleaned_count,
        sor_certified=sor_certified,
        cluster_exact=cluster_exact,
        flags=flags,
    )


def tiled_kitti_pipeline(
    mesh: Mesh,
    n: int,
    *,
    sor_k: int = 20,
    ransac_iters: int = 500,
    ransac_subsample: int | None = 4096,
    obstacle_cap: int = 16384,
    sor_cell_factor: int = 3,
    halo_cells: int = 4,
    tile_slack: float = 1.3,
    table_size: int = 1 << 21,
):
    """Jitted tiled KITTI pipeline over ``mesh`` ("frames", "points").

    (xyz [B, n, 3], valid [B, n], voxel, sor_std, ransac_thresh,
    seeds [B], cluster_r) -> TiledKittiOutput batched over frames.
    ``n`` is the per-frame point capacity (static). Outputs are
    replicated over the points axis."""
    p = mesh.shape["points"]
    # pair_cap: rows one source device may route to one tile. Quantile
    # boundaries balance per-TILE loads at ~n/P; per-PAIR loads are
    # ~n/P^2 when the input row order is spatially mixed (true of real
    # scans and the scene generators) — spatially-sorted input orders
    # can skew a pair up to n/P, which the route_overflow flag reports.
    # The merged tile array is P * pair_cap rows ~ (n/P) * slack — the
    # P-fold shrink of the dominant sorts that this design is for.
    pair_cap = _round128(int(n // p // p * tile_slack)) if p > 1 else _round128(n)
    ds_tile_cap = _round128(p * pair_cap)
    halo_cap = _round128(max(n // (p * 8), 1024))

    frame = partial(
        _tiled_frame, p=p, factor=int(sor_cell_factor), sor_k=sor_k,
        ransac_iters=ransac_iters, ransac_subsample=ransac_subsample,
        obstacle_cap=obstacle_cap, pair_cap=pair_cap,
        ds_tile_cap=ds_tile_cap, halo_cap=halo_cap, halo_cells=halo_cells,
        table_size=table_size,
    )

    def body(xs, vs, voxel, sor_std, r_thresh, seeds, cluster_r):
        return jax.vmap(
            lambda xyz, valid, seed: frame(
                xyz, valid, voxel, sor_std, r_thresh, seed, cluster_r
            )
        )(xs, vs, seeds)

    fspec = P("frames")
    out_specs = TiledKittiOutput(
        plane_normal=P("frames", None),
        plane_d=fspec,
        centroids=P("frames", None, None),
        downsampled_valid=P("frames", None),
        cleaned_valid=P("frames", None),
        obstacle_xyz=P("frames", None, None),
        obstacle_valid=P("frames", None),
        labels=P("frames", None),
        cleaned_count=fspec,
        sor_certified=fspec,
        cluster_exact=fspec,
        flags=P("frames", None),
    )
    sm = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P("frames", "points", None),
            P("frames", "points"),
            P(),
            P(),
            P(),
            P("frames"),
            P(),
        ),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(sm)


class TiledAerialOutput(NamedTuple):
    plane_normal: jax.Array  # f32[B, 3]
    plane_d: jax.Array  # f32[B]
    centroids: jax.Array  # f32[B, P*DCAP, 3] gathered, tile-major order
    downsampled_valid: jax.Array  # bool[B, P*DCAP]
    normals: jax.Array  # f32[B, P*DCAP, 3]
    normals_ok: jax.Array  # bool[B, P*DCAP]
    obstacle_xyz: jax.Array  # f32[B, CAP, 3]
    obstacle_valid: jax.Array  # bool[B, CAP]
    labels: jax.Array  # i32[B, CAP]
    cluster_exact: jax.Array  # bool[B]
    flags: jax.Array  # bool[B, 4]: route/ds/halo overflow, obstacle ovf


def _tiled_aerial_frame(xyz, valid, voxel, ransac_thresh, seed, cluster_r,
                        viewpoint, *, p: int, factor: int, normals_k: int,
                        ransac_iters: int, ransac_subsample,
                        obstacle_cap: int, pair_cap: int, ds_tile_cap: int,
                        halo_cap: int, halo_cells: int, table_size: int,
                        cluster_wr: int):
    """One aerial frame on one tile: route -> tile-local voxel ->
    halo -> tile-local KNN-moments normals -> replicated RANSAC+cluster
    tail. The moments search reaches one normals cell (= ``factor``
    voxels), so ``halo_cells`` = 1 reproduces the unsharded candidate
    sets for owned rows (mirrors pipelines/aerial.py, which runs no
    rescue by default)."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    finite = jnp.isfinite(x) & jnp.isfinite(y) & jnp.isfinite(z)
    use = jnp.logical_and(valid, finite)

    c = cell_coords(xyz, voxel)
    big32 = jnp.int32(2**30)
    mn_loc = jnp.min(jnp.where(use[:, None], c, big32), axis=0)
    mn_v = jnp.minimum(jax.lax.pmin(mn_loc, "points"), big32 - 1)
    rel = jnp.clip(c - mn_v[None, :], 0, None)
    mx_loc = jnp.max(jnp.where(use[:, None], rel, 0), axis=0)
    mx_rel = jax.lax.pmax(mx_loc, "points")
    ext_v = mx_rel + 1
    ext64 = ext_v.astype(jnp.int64)
    esc = mx_rel // factor + 1
    esc64 = esc.astype(jnp.int64)
    table_overflow = jnp.logical_or(
        (esc64[0] * esc64[1] * esc64[2]) > table_size,
        (ext64[0] * ext64[1] * ext64[2]) > 2**31 - 2,
    )
    ckey64 = (rel[:, 0].astype(jnp.int64) * ext64[1] + rel[:, 1]) * ext64[
        2
    ] + rel[:, 2]
    ckey = jnp.where(
        use, jnp.clip(ckey64, 0, 2**31 - 2).astype(jnp.int32), _INVALID32
    )

    mkey, mx_, my_, mz_, route_overflow, lo_t, hi_t = _route_to_tiles(
        ckey, x, y, z, use, ext_v, esc, p=p, factor=factor,
        pair_cap=pair_cap,
    )

    ep = voxel_scan_sor_epilogue(
        mkey, mx_, my_, mz_, ext_v, esc, factor=factor,
        ds_cap=ds_tile_cap, table_size=table_size,
    )
    centroids, ds_valid = ep["centroids"], ep["out_valid"]
    slin, canon = ep["slin"], ep["canon"]
    ds_overflow = ep["ds_overflow"]

    m_xyz, m_valid, m_slin, nli, halo_ovf = _halo_merge(
        centroids, ds_valid, slin, esc, lo_t, hi_t, p=p,
        halo_cells=halo_cells, halo_cap=halo_cap,
        ds_tile_cap=ds_tile_cap, table_size=table_size,
    )

    # ── Tile-local KNN-moments normals on the merged frame ──
    from ..ops.normals import normals_from_moment_rows
    from ..spatial.sweep import sweep_knn_moments_rows

    hi_v = jnp.max(
        jnp.maximum(jnp.abs(mn_v), jnp.abs(mn_v + ext_v)).astype(jnp.float32)
    )
    hi_cells = (hi_v + float(factor)) / float(factor)
    prebuilt = structure_from_sorted(
        m_xyz, m_valid, m_slin, esc, hi_cells, table_overflow, wr=4,
        table_size=table_size, grid_origin=(mn_v, voxel, factor),
    )
    normals_cell = voxel * float(factor)
    m1r, m2r, cnt, nok_m = sweep_knn_moments_rows(
        m_xyz, m_valid, normals_cell, k=normals_k, prebuilt=prebuilt,
    )
    nli32 = nli.astype(jnp.int32)  # the psum'd count is i64 under x64
    m1o = jax.lax.dynamic_slice(m1r, (jnp.int32(0), nli32), (3, ds_tile_cap))
    m2o = jax.lax.dynamic_slice(m2r, (jnp.int32(0), nli32), (6, ds_tile_cap))
    cnto = jax.lax.dynamic_slice(cnt, (nli32,), (ds_tile_cap,))
    nok = jax.lax.dynamic_slice(nok_m, (nli32,), (ds_tile_cap,))
    normals = normals_from_moment_rows(m1o, m2o, cnto, centroids, viewpoint)

    # ── TAIL (replicated): gather, RANSAC, obstacle compaction, cluster ──
    g_xyz = jax.lax.all_gather(centroids, "points", axis=0, tiled=True)
    g_valid = jax.lax.all_gather(ds_valid, "points", axis=0, tiled=True)
    g_normals = jax.lax.all_gather(normals, "points", axis=0, tiled=True)
    g_nok = jax.lax.all_gather(nok, "points", axis=0, tiled=True)
    g_canon = jax.lax.all_gather(
        jnp.where(ds_valid, canon, _INVALID32), "points", axis=0, tiled=True
    )
    gkey = jnp.where(g_valid, g_canon, _INVALID32)
    _, position_rows = jax.lax.sort(
        (gkey, jnp.arange(gkey.shape[0], dtype=jnp.int32)),
        num_keys=1,
        is_stable=True,
    )
    normal, d, inlier = ransac_plane_masked(
        g_xyz, g_valid, ransac_thresh, seed, ransac_iters,
        score_subsample=ransac_subsample,
        adaptive=(ransac_subsample is None),
        position_rows=position_rows,
    )
    obstacle = jnp.logical_and(g_valid, jnp.logical_not(inlier))
    from ..core.cloud import compaction_order

    order = compaction_order(obstacle)
    obs_src = order[:obstacle_cap].astype(jnp.int32)
    obs_valid = jnp.take(obstacle, obs_src)
    obs_xyz = jnp.take(g_xyz, obs_src, axis=0)
    n_obstacle = jnp.sum(obstacle.astype(jnp.int32))
    obs_overflow = n_obstacle > obstacle_cap
    labels, cluster_exact = sweep_cluster_labels(
        obs_xyz, obs_valid, cluster_r, wr=cluster_wr, rep_labels=False,
    )

    flags = jnp.stack(
        [
            jax.lax.pmax(route_overflow.astype(jnp.int32), "points") > 0,
            jax.lax.pmax(ds_overflow.astype(jnp.int32), "points") > 0,
            jax.lax.pmax(halo_ovf.astype(jnp.int32), "points") > 0,
            obs_overflow,
        ]
    )
    return TiledAerialOutput(
        plane_normal=normal,
        plane_d=d,
        centroids=g_xyz,
        downsampled_valid=g_valid,
        normals=g_normals,
        normals_ok=g_nok,
        obstacle_xyz=obs_xyz,
        obstacle_valid=obs_valid,
        labels=labels,
        cluster_exact=cluster_exact,
        flags=flags,
    )


def tiled_aerial_pipeline(
    mesh: Mesh,
    n: int,
    *,
    normals_k: int = 15,
    normals_cell_factor: int = 6,
    ransac_iters: int = 300,
    ransac_subsample: int | None = 4096,
    obstacle_cap: int = 262_144,
    cluster_wr: int = 12,
    halo_cells: int = 1,
    tile_slack: float = 1.3,
    table_size: int = 1 << 21,
):
    """Jitted tiled AERIAL pipeline over ``mesh`` ("frames", "points"):
    (xyz [B, n, 3], valid [B, n], voxel, ransac_thresh, seeds [B],
    cluster_r, viewpoint f32[3]) -> TiledAerialOutput batched over
    frames. The normals certification cell is ``normals_cell_factor``
    voxels (6 x 0.5 m = the demo's 3.0 m)."""
    p = mesh.shape["points"]
    pair_cap = _round128(int(n // p // p * tile_slack)) if p > 1 else _round128(n)
    ds_tile_cap = _round128(p * pair_cap)
    halo_cap = _round128(max(n // (p * 8), 1024))

    frame = partial(
        _tiled_aerial_frame, p=p, factor=int(normals_cell_factor),
        normals_k=normals_k, ransac_iters=ransac_iters,
        ransac_subsample=ransac_subsample, obstacle_cap=obstacle_cap,
        pair_cap=pair_cap, ds_tile_cap=ds_tile_cap, halo_cap=halo_cap,
        halo_cells=halo_cells, table_size=table_size,
        cluster_wr=cluster_wr,
    )

    def body(xs, vs, voxel, r_thresh, seeds, cluster_r, viewpoint):
        return jax.vmap(
            lambda xyz, valid, seed: frame(
                xyz, valid, voxel, r_thresh, seed, cluster_r, viewpoint
            )
        )(xs, vs, seeds)

    fspec = P("frames")
    out_specs = TiledAerialOutput(
        plane_normal=P("frames", None),
        plane_d=fspec,
        centroids=P("frames", None, None),
        downsampled_valid=P("frames", None),
        normals=P("frames", None, None),
        normals_ok=P("frames", None),
        obstacle_xyz=P("frames", None, None),
        obstacle_valid=P("frames", None),
        labels=P("frames", None),
        cluster_exact=fspec,
        flags=P("frames", None),
    )
    sm = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P("frames", "points", None),
            P("frames", "points"),
            P(),
            P(),
            P("frames"),
            P(),
            P(),
        ),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(sm)
