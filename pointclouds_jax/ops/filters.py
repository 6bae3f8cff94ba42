"""Filters: voxel downsample, passthrough, statistical/radius outlier removal.

JAX lowering of the reference filter crate:
- voxel downsample: hash-grid centroid accumulation with sorted-key output
  (ref: crates/filters/src/voxel_downsample.rs:12-65) becomes encode-cell-key
  -> sort -> segment-sum, which is all fused XLA.
- passthrough: range mask (ref: crates/filters/src/passthrough.rs:3-23).
- statistical outlier removal: per-point mean distance to k nearest
  neighbours, global mean + population stddev threshold
  (ref: crates/filters/src/statistical_outlier.rs:4-69), on top of the
  batched neighbor engine.
- radius outlier removal: neighbor count within radius, self included
  (ref: crates/filters/src/radius_outlier.rs:4-18).

All functions are jittable, operate on padded masked arrays, and return
keep-masks or masked clouds of fixed shape.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..spatial.grid import cell_coords, pack_cell_key, INVALID_KEY


def _segscan_br(nrows: int) -> int:
    """Tile height of the segmented scan: one compiled shape per nrows."""
    return min(512, nrows)


def _segscan5_block(br: int):
    """Per-tile Hillis-Steele segmented inclusive scan of (flag, x, y, z,
    count) on [T, BR, 128] channel stacks: 7 lane steps, then log2(BR)
    row steps of roll + select + add."""

    def block(f, x, y, z, c):
        lane = jax.lax.broadcasted_iota(jnp.int32, (br, 128), 1)[None]
        row = jax.lax.broadcasted_iota(jnp.int32, (br, 128), 0)[None]
        flat = row * 128 + lane
        d = 1
        while d < 128:
            def sh(a, d=d):
                s1 = jnp.roll(a, d, axis=2)
                s2 = jnp.roll(s1, 1, axis=1)
                return jnp.where(lane < d, s2, s1)

            ok = flat >= d
            fs = jnp.where(ok, sh(f), 0.0)
            xs = jnp.where(ok, sh(x), 0.0)
            ys = jnp.where(ok, sh(y), 0.0)
            zs = jnp.where(ok, sh(z), 0.0)
            cs = jnp.where(ok, sh(c), 0.0)
            x = jnp.where(f > 0.5, x, x + xs)
            y = jnp.where(f > 0.5, y, y + ys)
            z = jnp.where(f > 0.5, z, z + zs)
            c = jnp.where(f > 0.5, c, c + cs)
            f = jnp.maximum(f, fs)
            d *= 2
        dr = 1
        while dr < br:
            def shr(a, dr=dr):
                return jnp.roll(a, dr, axis=1)

            ok = row >= dr
            fs = jnp.where(ok, shr(f), 0.0)
            xs = jnp.where(ok, shr(x), 0.0)
            ys = jnp.where(ok, shr(y), 0.0)
            zs = jnp.where(ok, shr(z), 0.0)
            cs = jnp.where(ok, shr(c), 0.0)
            x = jnp.where(f > 0.5, x, x + xs)
            y = jnp.where(f > 0.5, y, y + ys)
            z = jnp.where(f > 0.5, z, z + zs)
            c = jnp.where(f > 0.5, c, c + cs)
            f = jnp.maximum(f, fs)
            dr *= 2
        return f, x, y, z, c

    return block


@jax.jit
def segmented_scan_sums_xla(first, x, y, z, c):
    """Segmented inclusive scan of 4 f32 value channels over flat [N]
    arrays, segments starting where ``first`` = 1.0. Returns (sx, sy, sz,
    sc) f32[N]. Combine tree: per-tile Hillis-Steele (`_segscan5_block`)
    plus a sequential tile carry, so prefixes reset at every segment start
    and stay at per-segment magnitude."""
    n = first.shape[0]
    nrows = max(-(-n // 128), 1)
    br = _segscan_br(nrows)
    t = -(-nrows // br)
    pad = t * br * 128 - n
    if pad:
        zf = jnp.zeros((pad,), jnp.float32)
        first, x, y, z, c = (
            jnp.concatenate([a, zf]) for a in (first, x, y, z, c)
        )

    def shape3(a):
        return a.reshape(t, br, 128)

    f3, x3, y3, z3, c3 = (shape3(a) for a in (first, x, y, z, c))
    bf, bx, by, bz, bc = _segscan5_block(br)(f3, x3, y3, z3, c3)

    def step(carry, tile):
        cf, cx, cy, cz, cc = carry
        f, xx, yy, zz, ct = tile
        xo = jnp.where(f > 0.5, xx, xx + cx)
        yo = jnp.where(f > 0.5, yy, yy + cy)
        zo = jnp.where(f > 0.5, zz, zz + cz)
        co = jnp.where(f > 0.5, ct, ct + cc)
        nf = jnp.maximum(cf, f[-1, -1])
        return (nf, xo[-1, -1], yo[-1, -1], zo[-1, -1], co[-1, -1]), (
            xo, yo, zo, co
        )

    zero = jnp.float32(0.0)
    _, (ox, oy, oz, oc) = jax.lax.scan(
        step, (zero, zero, zero, zero, zero), (bf, bx, by, bz, bc)
    )
    return tuple(o.reshape(-1)[:n] for o in (ox, oy, oz, oc))


def _segment_sums(first, sx, sy, sz, scnt):
    """Per-segment inclusive sums of (x, y, z, count); only segment-END
    values are consumed downstream."""
    return segmented_scan_sums_xla(first.astype(jnp.float32), sx, sy, sz, scnt)


@jax.jit
def voxel_downsample_masked(xyz, valid, voxel_size):
    """Masked voxel-grid centroid downsample.

    Returns (centroids f32[N,3], out_valid bool[N]). Output voxels occupy the
    leading rows in ascending cell-key order — the same deterministic
    (ix, iy, iz) tuple ordering the reference produces by sorting hash-map
    keys (ref: crates/filters/src/voxel_downsample.rs:49-62). Non-finite
    points are skipped (ref :28-30).
    """
    n = xyz.shape[0]
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    finite = jnp.isfinite(x) & jnp.isfinite(y) & jnp.isfinite(z)
    use = jnp.logical_and(valid, finite)

    coords = cell_coords(xyz, voxel_size)
    key = jnp.where(use, pack_cell_key(coords), INVALID_KEY)

    # Payload-carrying stable sort: x/y/z ride the sort as independent 1-D
    # channels instead of an argsort followed by an [N, 3] row gather.
    skey, sx, sy, sz = jax.lax.sort(
        (key, x, y, z), num_keys=1, is_stable=True
    )
    suse = skey != INVALID_KEY
    sx = jnp.where(suse, sx, 0.0)
    sy = jnp.where(suse, sy, 0.0)
    sz = jnp.where(suse, sz, 0.0)
    scnt = suse.astype(jnp.float32)

    # Segment boundaries: a new segment starts where the sorted key changes.
    first = jnp.concatenate(
        [jnp.ones((1,), bool), skey[1:] != skey[:-1]]
    )

    # Per-segment sums via the segmented scan. A plain cumsum+diff loses
    # precision (the f32 prefix reaches ~1e7 where one ulp is meters); the
    # segmented scan RESETS at every voxel boundary, so prefixes stay at
    # per-voxel magnitude and the result is a per-voxel-magnitude f32
    # accumulation like the reference's.
    is_end = jnp.concatenate([first[1:], jnp.ones((1,), bool)])
    cx, cy, cz, ccnt = _segment_sums(first, sx, sy, sz, scnt)

    # Compact segment totals to the leading rows with ONE payload-carrying
    # stable sort keyed by ~is_end (False sorts first, stability keeps the
    # ends in ascending-key order) instead of a second full sort plus a
    # small-slice gather.
    dead = jnp.logical_not(is_end)
    _, ex, ey, ez, ecnt = jax.lax.sort(
        (dead, cx, cy, cz, ccnt), num_keys=1, is_stable=True
    )
    nseg = jnp.sum(first.astype(jnp.int32))
    in_range = jnp.arange(n, dtype=jnp.int32) < nseg
    counts = jnp.where(in_range, ecnt, 0.0)

    denom = jnp.maximum(counts, 1.0)
    centroids = jnp.stack([ex / denom, ey / denom, ez / denom], axis=1)
    out_valid = counts > 0.0
    return centroids, out_valid


def voxel_scan_sor_epilogue(skey, sx, sy, sz, ext_v, esc, *, factor: int,
                            ds_cap: int, table_size: int):
    """Shared back half of `voxel_downsample_sweep_fused`: given rows
    ALREADY stably sorted by canonical voxel key (``skey`` ascending,
    invalid rows = 2^31-1 sentinel last, coords zeroed on invalid), run
    the segmented per-voxel mean scan and the single sor-order compaction
    sort. ``ext_v``/``esc`` are the voxel / sor grid extents the keys
    were linearized with (value-level — the tiled points-axis pipeline
    passes GLOBAL extents so per-tile keys stay mutually consistent).

    Returns dict(centroids f32[ds_cap, 3], out_valid bool[ds_cap],
    slin i32[ds_cap] ascending sor ids (table_size sentinel), canon
    i32[ds_cap], ds_overflow bool)."""
    invalid32 = jnp.int32(2**31 - 1)
    suse = skey != invalid32
    sx = jnp.where(suse, sx, 0.0)
    sy = jnp.where(suse, sy, 0.0)
    sz = jnp.where(suse, sz, 0.0)
    scnt = suse.astype(jnp.float32)
    first = jnp.concatenate([jnp.ones((1,), bool), skey[1:] != skey[:-1]])
    is_end = jnp.concatenate([first[1:], jnp.ones((1,), bool)])
    cx, cy, cz, ccnt = _segment_sums(first, sx, sy, sz, scnt)

    # Sort 2 (the ONLY post-scan sort): key = sor-cell linear id for
    # segment-end rows, table_size sentinel otherwise — one stable sort
    # compacts AND orders for the sweep (equal sor keys keep canonical
    # voxel order: the scan rows are already canonical).
    live = jnp.logical_and(is_end, suse)
    r0 = skey // (ext_v[1] * ext_v[2])
    r1 = (skey // ext_v[2]) % jnp.maximum(ext_v[1], 1)
    r2 = skey % jnp.maximum(ext_v[2], 1)
    lin_sc = ((r0 // factor) * esc[1] + r1 // factor) * esc[2] + r2 // factor
    lin_sc = jnp.clip(lin_sc, 0, table_size - 1)
    sorkey = jnp.where(live, lin_sc, jnp.int32(table_size))
    # Divide BEFORE the sort: the per-row mean is elementwise, so the
    # centroid values are bitwise identical either way, and the count
    # channel drops out of the n-row payload sort (6 -> 5 channels).
    denom_all = jnp.maximum(ccnt, 1.0)
    ekey, ex, ey, ez, ecanon = jax.lax.sort(
        (sorkey, cx / denom_all, cy / denom_all, cz / denom_all,
         jnp.where(live, skey, invalid32)),
        num_keys=1,
        is_stable=True,
    )
    nseg = jnp.sum(live.astype(jnp.int32))
    ds_overflow = nseg > ds_cap

    slin = ekey[:ds_cap]
    out_valid = slin != jnp.int32(table_size)
    centroids = jnp.stack(
        [
            jnp.where(out_valid, ex[:ds_cap], 0.0),
            jnp.where(out_valid, ey[:ds_cap], 0.0),
            jnp.where(out_valid, ez[:ds_cap], 0.0),
        ],
        axis=1,
    )
    return dict(
        centroids=centroids,
        out_valid=out_valid,
        slin=slin,
        canon=ecanon[:ds_cap],
        ds_overflow=ds_overflow,
    )


@partial(jax.jit, static_argnames=("factor", "ds_cap", "table_size"))
def voxel_downsample_sweep_fused(xyz, valid, voxel_size, *, factor: int,
                                 ds_cap: int,
                                 table_size: int = 1 << 21):
    """Voxel downsample emitting rows DIRECTLY in sor-cell-major sweep
    order, with ONE post-scan sort: the compaction key (segment ends
    first) and the sweep key (ascending sor cell) fold into a single
    stable sort, so the sweep needs no sort, inverse permutation or
    unsort gather of its own.

    Centroid VALUES are bitwise identical to `voxel_downsample_masked`
    (sort 1 and the segmented scan are unchanged). One semantic
    difference from the two-step path: when more voxels than ``ds_cap``
    exist, which ones are dropped differs (sweep-order tail, not
    canonical-order tail) — ds_overflow flags it either way and the
    pipelines assert it false.

    Returns a dict: centroids f32[ds_cap, 3], out_valid bool[ds_cap],
    slin i32[ds_cap] (ascending; table_size on invalid rows),
    canon i32[ds_cap], ds_overflow bool, extent i32[3], hi_cells f32,
    table_overflow bool.
    """
    n = xyz.shape[0]
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    finite = jnp.isfinite(x) & jnp.isfinite(y) & jnp.isfinite(z)
    use = jnp.logical_and(valid, finite)

    c = cell_coords(xyz, voxel_size)
    big32 = jnp.int32(2**30)
    mn_v = jnp.min(jnp.where(use[:, None], c, big32), axis=0)
    mn_v = jnp.minimum(mn_v, big32 - 1)
    rel = jnp.clip(c - mn_v[None, :], 0, None)
    mx_rel = jnp.max(jnp.where(use[:, None], rel, 0), axis=0)
    ext_v = mx_rel + 1
    ext64 = ext_v.astype(jnp.int64)
    esc = mx_rel // factor + 1
    esc64 = esc.astype(jnp.int64)
    table_overflow = jnp.logical_or(
        (esc64[0] * esc64[1] * esc64[2]) > table_size,
        (ext64[0] * ext64[1] * ext64[2]) > 2**31 - 2,
    )

    invalid32 = jnp.int32(2**31 - 1)
    ckey64 = (rel[:, 0].astype(jnp.int64) * ext64[1] + rel[:, 1]) * ext64[
        2
    ] + rel[:, 2]
    ckey = jnp.where(
        use, jnp.clip(ckey64, 0, 2**31 - 2).astype(jnp.int32), invalid32
    )

    # Sort 1 (CANONICAL order: identical per-voxel accumulation trees to
    # voxel_downsample_masked — centroids stay bitwise equal).
    skey, sx, sy, sz = jax.lax.sort(
        (ckey, x, y, z), num_keys=1, is_stable=True
    )
    ep = voxel_scan_sor_epilogue(
        skey, sx, sy, sz, ext_v, esc, factor=factor, ds_cap=ds_cap,
        table_size=table_size,
    )

    hi_v = jnp.max(
        jnp.maximum(jnp.abs(mn_v), jnp.abs(mn_v + ext_v)).astype(jnp.float32)
    )
    hi_cells = (hi_v + float(factor)) / float(factor)

    return dict(
        centroids=ep["centroids"],
        out_valid=ep["out_valid"],
        slin=ep["slin"],
        canon=ep["canon"],
        ds_overflow=ep["ds_overflow"],
        extent=esc,
        hi_cells=hi_cells,
        table_overflow=table_overflow,
        mn_v=mn_v,
    )


@partial(jax.jit, static_argnames=("factor", "table_size"))
def sweep_sort_compacted(cxm, cym, czm, canon, out_valid, ext_v, esc, *,
                         factor: int = 3, table_size: int = 1 << 21):
    """Sort 3 of the shared front end: the COMPACTED (and usually
    ds_cap-sliced) voxel rows into sor-cell-major sweep order. Returns
    (centroids f32[N,3], valid bool[N], slin i32[N], canon i32[N]) with
    slin ascending and invalid rows at the tail — `structure_from_sorted`
    input. The sor-cell id is decoded from the canonical rank key, so the
    grid is exactly the integer voxel grid coarsened by ``factor``."""
    invalid32 = jnp.int32(2**31 - 1)
    ck = jnp.where(out_valid, canon, 0)
    r0 = ck // (ext_v[1] * ext_v[2])
    r1 = (ck // ext_v[2]) % ext_v[1]
    r2 = ck % ext_v[2]
    lin_sc = ((r0 // factor) * esc[1] + r1 // factor) * esc[2] + r2 // factor
    lin_sc = jnp.clip(lin_sc, 0, table_size - 1)
    sorkey = jnp.where(out_valid, lin_sc, jnp.int32(table_size))
    skey, sx, sy, sz, scanon = jax.lax.sort(
        (sorkey, cxm, cym, czm, jnp.where(out_valid, canon, invalid32)),
        num_keys=1,
        is_stable=True,
    )
    svalid = skey != jnp.int32(table_size)
    return (
        jnp.stack(
            [
                jnp.where(svalid, sx, 0.0),
                jnp.where(svalid, sy, 0.0),
                jnp.where(svalid, sz, 0.0),
            ],
            axis=1,
        ),
        svalid,
        skey,
        scanon,
    )


def passthrough_mask(xyz, valid, axis_index: int, lo, hi):
    """Keep-mask for min <= v <= max and finite on one axis.

    (ref: crates/filters/src/passthrough.rs:3-23)
    """
    v = xyz[:, axis_index]
    keep = jnp.isfinite(v) & (v >= lo) & (v <= hi)
    return jnp.logical_and(valid, keep)


def sor_keep_mask_thr(mean_dists, valid, std_mul):
    """`sor_keep_mask` + the f64 threshold itself (for the keep-DECISION
    certificate: a flagged row whose mean LOWER bound exceeds thr is
    provably removed; one whose UPPER bound passes <= thr is provably
    kept — pipelines/kitti.py)."""
    finite = jnp.logical_and(valid, jnp.isfinite(mean_dists))
    # f64 accumulation: the threshold becomes insensitive (to ~1e-16
    # relative) to the reduction ORDER, so sharded/tiled executions that
    # psum per-shard partial sums (parallel/tiles.py) reproduce this
    # threshold bit-for-all-practical-purposes — keep decisions match the
    # unsharded run except for mean_dists within ~1e-16 of the threshold.
    md64 = mean_dists.astype(jnp.float64)
    n = jnp.maximum(jnp.sum(finite.astype(jnp.float64)), 1.0)
    mean = jnp.sum(jnp.where(finite, md64, 0.0)) / n
    var = jnp.sum(jnp.where(finite, (md64 - mean) ** 2, 0.0)) / n
    threshold = mean + std_mul * jnp.sqrt(var)
    keep = jnp.logical_and(valid, md64 <= threshold)
    # If no finite mean distances exist the reference returns an empty cloud
    # (ref :52-54); mean over zero samples would be 0 here, but the <= above
    # already fails for every point since all mean_dists are +inf.
    return keep, threshold


def sor_keep_mask(mean_dists, valid, std_mul):
    """Statistical-outlier keep mask from per-point mean neighbor distances.

    Global mean and *population* stddev are computed over finite mean
    distances only; points kept iff mean_dist <= mean + std_mul * std
    (ref: crates/filters/src/statistical_outlier.rs:43-66). Non-finite
    mean distances (isolated / non-finite points) always fail the <=.
    """
    return sor_keep_mask_thr(mean_dists, valid, std_mul)[0]


def sor_mean_dists_from_knn(neighbor_dists, neighbor_valid, query_finite):
    """Mean distance to up-to-k nearest non-self neighbours.

    ``neighbor_dists``/``neighbor_valid`` are [N, k+1] from a KNN query that
    includes the query point itself as its nearest result (distance 0). The
    first (self) column is skipped; if only one result exists, it is used
    as-is; zero results or a non-finite query give +inf
    (ref: crates/filters/src/statistical_outlier.rs:19-39).
    """
    counts = jnp.sum(neighbor_valid.astype(jnp.int32), axis=1)
    # Skip the self column unless it is the only result.
    skip_first = counts > 1
    use = jnp.where(skip_first[:, None], neighbor_valid.at[:, 0].set(False), neighbor_valid)
    denom = jnp.maximum(jnp.sum(use.astype(jnp.float32), axis=1), 1.0)
    mean = jnp.sum(jnp.where(use, neighbor_dists, 0.0), axis=1) / denom
    empty = counts == 0
    mean = jnp.where(jnp.logical_and(query_finite, jnp.logical_not(empty)), mean, jnp.inf)
    return mean
