"""Sorted-window sweep: gather-free neighbor queries for whole-cloud SOR.

The block-engine SOR (`cellgrid.point_sor_mean_dists`) is fetch-bound: every
query gathers its cell's 27-block slab (~24 KB) from HBM, duplicating the
fetch for every co-resident point. This module removes the gathers entirely:

1. points are sorted by linearized cell id (z fastest) and packed into a
   planar row layout ([x*128 | y*128 | z*128 | w*128] per 128 points);
2. for a block of 128 consecutive sorted queries, the union of all their
   27-cell neighborhoods collapses into NINE CONTIGUOUS row windows of the
   sorted array — one per (dx, dy) shift, the z+-1 neighbors merging into
   the window span (points between needed cells ride along as harmless
   extra candidates: k-smallest over a superset is still exact);
3. each block slices its 9 windows and runs the segmented k-smallest
   selection over them (`_sweep_select_xla`): one [128, 9*wr*128] distance
   tile per block, no gathers.

Exactness is certified per query exactly like the block engine: the kth
squared distance must stay within one (margin-shrunk) cell width, the
window spans must have covered every needed row (per-block length
certificate), and the segment certificate must pass. Flagged queries join
the callers' rescue pass.

Replaces the reference's per-point KD-tree SOR queries
(ref: crates/filters/src/statistical_outlier.rs:19-39,
crates/spatial/src/kdtree.rs:64-103) with a formulation whose hot loop is
contiguous slices plus dense elementwise work and reductions.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .cellgrid import _segmented_smallest_k

SWEEP_TABLE_SIZE = 1 << 21  # dense cell table (i32, 8 MB)
NSHIFT = 9

# Relative inclusion band for two-phase selections that re-derive d2
# against a kth threshold (the KNN moments): ~7 ulp, comfortably above any
# FMA-contraction or summation-order jitter in a 3-term squared distance,
# far below any physically distinct neighbor distance.
D2_BAND = 8e-7


def _shift_offsets(extent):
    """[9] linear-id offsets for the (dx, dy) in {-1,0,1}^2 shifts."""
    sh = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            sh.append((dx * extent[1] + dy) * extent[2])
    return jnp.stack(sh)


def _window_starts(slin_p, suse_p, extent, nrows, nb, wr, table_size):
    """Per-block window start rows, dedup skip counts, window LENGTHS, and
    the per-block length certificate, for 128-query blocks of the
    cell-sorted array (query blocks ARE the point blocks — the same-cloud
    sweep). See `_window_starts_from_bounds` for the shared core.

    Returns (starts_pack i32[NB, 3*NSHIFT + 1], block_ok bool[NB]):
    columns [0, S) window start rows, [S, 2S) dedup skip counts, [2S, 3S)
    window lengths in rows, [3S] = 1 iff the block holds any valid query.
    A window covers sorted rows [start + skip, start + len); fully-invalid
    blocks get zero-length windows and a 0 valid flag, so kernels skip
    them entirely.
    """
    lo = slin_p[: nb * 128].reshape(nb, 128)[:, 0]
    hi = slin_p[: nb * 128].reshape(nb, 128)[:, -1]
    has_valid = jnp.any(suse_p[: nb * 128].reshape(nb, 128), axis=1)
    return _window_starts_from_bounds(
        lo, hi, has_valid, slin_p, suse_p, extent, nrows, nb, wr, table_size
    )


def _window_starts_from_bounds(lo, hi, has_valid, slin_p, suse_p, extent,
                               nrows, p_nb, wr, table_size):
    """Window pack for ARBITRARY query blocks against the cell-sorted
    point rows: ``lo``/``hi`` i32[QB] are each query block's first/last
    cell id (sorted ascending within the query frame), ``has_valid``
    bool[QB] its any-valid flag; ``slin_p``/``suse_p`` are the POINT
    side's padded sorted cell ids / validity (`p_nb` real point blocks,
    ``nrows`` padded point rows / 128). The cross-cloud sweep passes a
    separately sorted query frame here; the same-cloud sweep passes its
    own blocks."""
    nb = lo.shape[0]
    # Fully-invalid blocks (lo == sentinel) get empty windows below (their
    # needed span clamps to first >= last), and flag 0.
    sh = _shift_offsets(extent)  # [9]
    a = jnp.clip(lo[:, None] + sh[None, :] - 1, 0, table_size)  # [NB, 9]
    zhi = jnp.clip(hi[:, None] + sh[None, :] + 1, 0, table_size)

    # first_row(c) = #rows with cell id < c (rows are cell-sorted). Small
    # blocked clouds count it directly from the 128-row block boundaries
    # (one [Q, PB] compare + one boundary-block row gather); large clouds
    # build the dense first-row table + suffix-min scan (a scatter + a
    # 2M-entry cummin, where the compare matrix would be [Q, PB^2]-sized).
    all_rows = slin_p.shape[0]
    nbt = slin_p[: p_nb * 128].reshape(p_nb, 128)
    p_hi = nbt[:, -1]  # last cell id per POINT block

    def rows_less_blocked(c):
        # c i32[NB, W] query cell ids -> i32[NB, W] row counts. All
        # intermediates FLAT-2-D [NB*W, PB] / [NB*W, 128].
        w = c.shape[1]
        cf = c.reshape(nb * w, 1)
        nfull = jnp.sum(
            p_hi[None, :] < cf, axis=1, dtype=jnp.int32
        )  # [NB*W] point blocks fully below c
        jb = jnp.minimum(nfull, p_nb - 1)
        brow = jnp.take(nbt, jb, axis=0)  # [NB*W, 128] flat 1-D gather
        cin = jnp.sum(brow < cf, axis=1, dtype=jnp.int32)
        cnt = jnp.where(nfull >= p_nb, p_nb * 128, nfull * 128 + cin)
        # Rows beyond p_nb*128 (the wr padding tail) hold sentinel ids and
        # are never < c (c <= table_size + 1 only counts them when the
        # dense path's synthetic total-row entry would — the clamps below
        # make both formulations agree).
        return jnp.minimum(cnt, all_rows).reshape(nb, w)

    if nb <= 2048 and p_nb <= 2048:
        first_row = rows_less_blocked(a)
        last_row_raw = rows_less_blocked(zhi + 1)
    else:
        pos = jnp.arange(nrows * 128, dtype=jnp.int32)
        first = jnp.concatenate(
            [jnp.ones((1,), bool), slin_p[1:] != slin_p[:-1]]
        )
        raw = (
            jnp.full((table_size + 1,), jnp.int32(2**30), jnp.int32)
            .at[jnp.where(first, slin_p, table_size + 1)]
            .set(jnp.where(first, pos, jnp.int32(2**30)), mode="drop")
        )
        raw = jnp.concatenate(
            [raw, jnp.array([slin_p.shape[0]], jnp.int32)]
        )
        prefix = jax.lax.cummin(raw, axis=0, reverse=True)
        first_row = jnp.take(prefix, a)
        last_row_raw = jnp.take(prefix, zhi + 1)

    # Exclusive end; clamp to the real (valid) row count so trailing masked
    # padding never counts as "needed coverage".
    n_use_rows = jnp.sum(suse_p.astype(jnp.int32))
    last_row = jnp.minimum(last_row_raw, n_use_rows)
    start = jnp.clip(first_row // 128, 0, nrows - wr).astype(jnp.int32)
    win_ok = jnp.logical_and(
        first_row >= start * 128, last_row <= (start + wr) * 128
    )
    # Empty windows (first_row >= last_row) are trivially covered.
    win_ok = jnp.logical_or(win_ok, first_row >= last_row)
    block_ok = jnp.all(win_ok, axis=1)  # [NB]

    # Window length: rows actually containing the needed span. The
    # certificate above guarantees [first_row, last_row) fits in
    # [start*128, (start+len)*128) whenever len < wr didn't clip it; when
    # the span overflows wr rows, len = wr and block_ok is already False.
    need_end = jnp.clip(-((-last_row) // 128) - start, 0, wr)
    length = jnp.where(first_row >= last_row, 0, need_end).astype(jnp.int32)

    # Deduplicate overlapping windows: adjacent shifts can produce
    # overlapping windows (e.g. dy-neighbors differ by only extent[2]
    # linear ids) and a duplicated candidate would be DOUBLE-COUNTED by a
    # k-smallest extraction — an exactness bug, not just wasted work. The
    # shift offsets are ascending, so window starts are non-decreasing in
    # j; masking each window's rows that a previous window already READ
    # (cummax of start + len — the actual read end, now that windows stop
    # at their length) keeps the candidate multiset a set.
    cover_end = jax.lax.cummax(start + length, axis=1)  # rows read by <= j
    prev_end = jnp.concatenate(
        [jnp.zeros((nb, 1), jnp.int32), cover_end[:, :-1]], axis=1
    )
    skip = jnp.clip(prev_end - start, 0, wr).astype(jnp.int32)  # [NB, 9]

    return (
        jnp.concatenate(
            [start, skip, length, has_valid.astype(jnp.int32)[:, None]],
            axis=1,
        ),
        block_ok,
    )


def structure_from_sorted(xyz_sorted, valid_sorted, slin, extent, hi_cells,
                          table_overflow, wr: int,
                          table_size: int = SWEEP_TABLE_SIZE,
                          grid_origin=None):
    """Sweep structure for rows ALREADY sorted by ascending sor-cell id
    (identity permutation — e.g. `voxel_downsample_sweep_frontend` output).
    Skips the payload sort, the inverse-permutation sort, and downstream
    consumers skip the unsort gather: results stay in row order.

    ``slin`` i32[N]: per-row linear cell id, ascending, ``table_size``
    sentinel on invalid rows (which must occupy the tail).

    ``grid_origin``: optional (mn_v i32[3], voxel_size f32, factor int)
    — the voxel-lattice origin the cell ids were derived from (cell a of
    axis j spans coords [voxel*(mn_v[j] + a*factor),
    voxel*(mn_v[j] + (a+1)*factor))). When present, pass 1 certifies
    with the PER-QUERY coverage radius (distance from the query to its
    3x3x3 window slab boundary, 1.0-1.5 cells) instead of the
    one-cell-width worst case — at the KITTI operating point that cuts
    the flagged count several-fold."""
    n = xyz_sorted.shape[0]
    assert n % 128 == 0, n
    nrows = max(n // 128, wr)
    nb = n // 128
    tail = nrows * 128 - n
    sx = jnp.where(valid_sorted, xyz_sorted[:, 0], 0.0)
    sy = jnp.where(valid_sorted, xyz_sorted[:, 1], 0.0)
    sz = jnp.where(valid_sorted, xyz_sorted[:, 2], 0.0)
    if tail:
        ftail = jnp.zeros((tail,), jnp.float32)
        slin_p = jnp.concatenate(
            [slin, jnp.full((tail,), table_size, jnp.int32)]
        )
        sx = jnp.concatenate([sx, ftail])
        sy = jnp.concatenate([sy, ftail])
        sz = jnp.concatenate([sz, ftail])
        suse_p = jnp.concatenate([valid_sorted, jnp.zeros((tail,), bool)])
    else:
        slin_p, suse_p = slin, valid_sorted
    planar = jnp.stack(
        [
            sx.reshape(nrows, 128),
            sy.reshape(nrows, 128),
            sz.reshape(nrows, 128),
            suse_p.astype(jnp.float32).reshape(nrows, 128),
        ],
        axis=1,
    )
    starts_skip, block_ok = _window_starts(
        slin_p, suse_p, extent, nrows, nb, wr, table_size
    )
    return dict(
        planar=planar,
        order=None,  # identity: row i IS sorted position i
        inv=None,
        use=valid_sorted,
        starts_skip=starts_skip,
        block_ok=block_ok,
        mn=None,
        extent=extent,
        hi_cells=hi_cells,
        nrows=nrows,
        nb=nb,
        table_overflow=table_overflow,
        slin_p=slin_p,
        grid_origin=grid_origin,
    )


def _sweep_pass1(
    xyz,
    valid,
    cell_size,
    *,
    k: int,
    wr: int = 4,
    per_seg: int = 4,
    table_size: int = SWEEP_TABLE_SIZE,
    prebuilt=None,
):
    """Shared pass-1 internals: sort, pack, windows, selection, mean +
    certificates. Returns a dict with the results AND the reusable sorted
    structure (planar array, permutations) for the rescue pass.

    ``prebuilt``: a `structure_from_sorted` dict — the sort/pack/window
    phase is skipped and (with its identity permutation) so is the unsort;
    results come back in row order either way."""
    n = xyz.shape[0]
    kp1 = k + 1
    if prebuilt is None:
        s = _sorted_structure(xyz, valid, cell_size, wr, table_size)
    else:
        s = prebuilt
    planar = s["planar"]
    starts_skip = s["starts_skip"]
    order, inv, use = s["order"], s["inv"], s["use"]
    table_overflow = s["table_overflow"]
    block_ok = s["block_ok"]

    # ── Windowed selection ──
    total, count, kth, seg_ok = _sweep_select_xla(
        planar, starts_skip, k=kp1, wr=wr, per_seg=per_seg
    )
    count_f = count.astype(jnp.float32)

    ok_sorted = jnp.logical_and(seg_ok, jnp.repeat(block_ok, 128))

    # ── Mean + certificates, computed in the SORTED frame (elementwise,
    # so it commutes with the unsort; the in-place rescue then merges
    # positionally and only the final 2 channels ever get unsorted) ──
    # (nb from a SHAPE, not s["nb"]: ints inside a prebuilt dict become
    # tracers when the dict crosses an inner jit boundary.)
    nb = starts_skip.shape[0]
    use_s = planar[:nb, 3, :].reshape(-1) > 0.5  # [nb*128]
    count_s = count_f
    n_neighbors = jnp.maximum(count_s - 1.0, 0.0)
    mean_s = jnp.where(
        n_neighbors > 0,
        total / jnp.maximum(n_neighbors, 1.0),
        jnp.inf,
    )
    n_valid_total = jnp.sum(use_s.astype(jnp.int32))
    # max(.., 2): a padded cloud with exactly ONE valid point must FAIL
    # certification (count=1 < want=2) and reach the callers' brute rescue,
    # which reproduces the reference's use-self-distance-as-is semantics
    # (mean 0, point kept; ref statistical_outlier.rs "if only one result
    # exists, use as-is") instead of certifying mean=+inf here.
    want = jnp.minimum(kp1, jnp.maximum(n_valid_total, 2))
    wantf = want.astype(jnp.float32)
    mean_s = jnp.where(count_s >= wantf, mean_s, jnp.inf)
    mean_s = jnp.where(use_s, mean_s, jnp.inf)

    # f32 floor-rounding margin (same derivation as cellgrid.cert_cell2):
    # |coord|/cell bound from the grid's own cell extents. Prebuilt
    # structures carry the bound directly (their grid came from integer
    # voxel coords, not floor(xyz / cell)).
    if s.get("hi_cells") is not None:
        hi_cells = s["hi_cells"]
    else:
        mn, extent = s["mn"], s["extent"]
        hi_cells = jnp.max(
            jnp.maximum(jnp.abs(mn), jnp.abs(mn + extent)).astype(jnp.float32)
        )
    margin = (hi_cells * 4.0 * 1.2e-7 + 1e-6) * cell_size
    origin = s.get("grid_origin")
    if origin is not None and s.get("slin_p") is not None:
        # PER-QUERY coverage radius: the block windows span the full
        # 3x3x3 cell neighborhood of every query's cell, so candidates
        # within min-over-axes(distance from q to its slab's OUTER
        # boundary) are provably all present — that radius is 1.0 cells
        # only for queries AT a cell corner and up to 1.5 cells for
        # centered ones (kth at k=20 sits right at ~1 cell width on
        # KITTI ground, so the worst-case-width certificate flagged
        # ~59% of rows; this per-query form certifies most of them).
        # Slab corners are voxel * integer (exact to 1 ulp); the margin
        # absorbs that and the query-coordinate rounding.
        mn_v, voxel_g, factor_g = origin
        sl = s["slin_p"][: nb * 128]
        e1 = jnp.maximum(s["extent"][1], 1)
        e2 = jnp.maximum(s["extent"][2], 1)
        c0 = sl // (e1 * e2)
        c1 = (sl // e2) % e1
        c2 = sl % e2
        qx = planar[:nb, 0, :].reshape(-1)
        qy = planar[:nb, 1, :].reshape(-1)
        qz = planar[:nb, 2, :].reshape(-1)
        fg = jnp.int32(factor_g)

        def cov(c, q, a):
            lo = voxel_g * ((mn_v[a] + (c - 1) * fg).astype(jnp.float32))
            hi = voxel_g * ((mn_v[a] + (c + 2) * fg).astype(jnp.float32))
            return jnp.minimum(q - lo, hi - q)

        rcov = jnp.minimum(
            jnp.minimum(cov(c0, qx, 0), cov(c1, qy, 1)), cov(c2, qz, 2)
        )
        safe_q = jnp.maximum(jnp.minimum(rcov, 1.5 * cell_size) - margin, 0.0)
        cell2 = safe_q * safe_q
    else:
        safe = jnp.maximum(cell_size - margin, 0.0)
        cell2 = safe * safe

    # Machinery soundness alone (windows complete, selection certified):
    # candidate sets are then provably COMPLETE within the coverage
    # radius even when the kth-distance test below fails — the basis for
    # the lower-bound decision certificate (with_lb consumers).
    machine_ok_s = jnp.logical_and(
        jnp.logical_and(ok_sorted, use_s),
        jnp.logical_not(table_overflow),
    )
    point_ok_s = jnp.logical_and(machine_ok_s, count_s >= wantf)
    point_ok_s = jnp.logical_and(point_ok_s, kth <= cell2)
    certified = jnp.logical_not(
        jnp.any(jnp.logical_and(use_s, jnp.logical_not(point_ok_s)))
    )
    out = dict(
        mean_s=mean_s,
        point_ok_s=point_ok_s,
        use_s=use_s,
        certified=certified,
        planar=planar,
        order=order,
        inv=inv,
        use=use,
        n_valid_total=n_valid_total,
        want=want,
        mn=s["mn"],
        extent=s["extent"],
        nb=nb,
        table_overflow=table_overflow,
        total_s=total,
        count_s=count_s,
        safe2_s=cell2,
        machine_ok_s=machine_ok_s,
        kth_s=kth,
    )
    out["mean"], out["point_ok"] = _unsort_mean_ok(
        mean_s, point_ok_s, inv, n
    )
    return out


def _unsort_mean_ok(mean_s, point_ok_s, inv, n):
    """Sorted-frame (mean, ok) -> row order: slice on the identity
    permutation, else ONE packed 2-channel gather."""
    if inv is None:
        return mean_s[:n], point_ok_s[:n]
    packed = jnp.stack([mean_s, point_ok_s.astype(jnp.float32)])
    res = jnp.take(packed, inv, axis=1)  # [2, n]
    return res[0], res[1] > 0.5


@partial(jax.jit, static_argnames=("k", "wr", "per_seg", "table_size"))
def sweep_sor_mean_dists(
    xyz,
    valid,
    cell_size,
    *,
    k: int,
    wr: int = 4,
    per_seg: int = 4,
    table_size: int = SWEEP_TABLE_SIZE,
):
    """Mean distance to the k nearest neighbors per point (self included in
    the k+1 extraction), via the sorted-window sweep.

    Same contract as `cellgrid.point_sor_mean_dists`: returns
    (means f32[N] (+inf where unresolved/invalid), point_ok bool[N],
    certified bool[]). ``cell_size`` is the certification radius: a query
    is certified only if its (k+1)-th neighbor lies within one
    margin-shrunk cell width.
    """
    p = _sweep_pass1(
        xyz,
        valid,
        cell_size,
        k=k,
        wr=wr,
        per_seg=per_seg,
        table_size=table_size,
    )
    return p["mean"], p["point_ok"], p["certified"]


def _sweep_select_xla(planar, starts_skip, *, k: int, wr: int, per_seg: int):
    """Per-block windowed selection: each 128-query block slices its 9
    windows and runs the segmented k-smallest selection
    (`cellgrid._segmented_smallest_k`) over the candidates."""
    nb = starts_skip.shape[0]
    nshift = (starts_skip.shape[1] - 1) // 3

    def block_fn(args):
        ss, qrow = args  # ss i32[3S+1], qrow f32[4, 128]
        st = ss[:nshift]
        sk = ss[nshift : 2 * nshift]
        ln = ss[2 * nshift : 3 * nshift]
        qx = qrow[0]
        qy = qrow[1]
        qz = qrow[2]
        qm = qrow[3] > 0.5

        def win_fn(s):
            return jax.lax.dynamic_slice(
                planar, (s, jnp.int32(0), jnp.int32(0)), (wr, 4, 128)
            )

        wins = jax.vmap(win_fn)(st)  # [9, wr, 4, 128]
        rr = jnp.arange(wr, dtype=jnp.int32)[None, :]
        rkeep = jnp.logical_and(
            rr >= sk[:, None], rr < ln[:, None]
        )  # [9, wr] dedup + length row mask
        cx = wins[:, :, 0, :].reshape(-1)
        cy = wins[:, :, 1, :].reshape(-1)
        cz = wins[:, :, 2, :].reshape(-1)
        cw = jnp.logical_and(
            wins[:, :, 3, :] > 0.5, rkeep[:, :, None]
        ).reshape(-1)
        d2 = (
            (qx[:, None] - cx[None, :]) ** 2
            + (qy[:, None] - cy[None, :]) ** 2
            + (qz[:, None] - cz[None, :]) ** 2
        )  # [128, 9*wr*128]
        v = jnp.logical_and(qm[:, None], cw[None, :])
        return _segmented_smallest_k(d2, v, k, per_seg=per_seg)

    totals, counts, kths, oks = jax.lax.map(
        block_fn, (starts_skip, planar[:nb])
    )
    return (
        totals.reshape(-1),
        counts.reshape(-1),
        kths.reshape(-1),
        oks.reshape(-1),
    )


RESCUE_GROUP_ROWS = 8  # candidate rows (of 128 points) per prune group


@partial(
    jax.jit,
    static_argnames=(
        "k",
        "wr",
        "per_seg",
        "fix_cap",
        "rescue_cells",
        "table_size",
        "with_lb",
    ),
)
def sweep_sor_two_pass(
    xyz,
    valid,
    cell_size,
    *,
    k: int,
    fix_cap: int = 4096,
    rescue_cells: float = 4.0,
    wr: int = 4,
    per_seg: int = 4,
    table_size: int = SWEEP_TABLE_SIZE,
    prebuilt=None,
    with_lb: bool = False,
):
    """Pass-1 sweep + exact AABB-pruned brute rescue for flagged queries.

    Same (mean, point_ok, certified) contract as `sweep_sor_mean_dists`,
    but queries pass 1 could not certify (kth beyond one cell width,
    window overflow, segment certificate) are re-resolved EXACTLY against
    the whole cloud, with certification radius ``rescue_cells * cell_size``
    (the prune radius): up to ``fix_cap`` flagged queries, visiting only
    candidate row-groups whose bounding box intersects the rescue ball.
    Queries still uncertified after the rescue (isolated beyond the
    rescue radius, or more than fix_cap flagged) keep their rescued
    upper-bound means and point_ok=False — the same removal-biased
    semantics the coarse block-grid rescue had (pipelines/kitti.py
    documents it).

    ``prebuilt``: a `structure_from_sorted` dict; see `_sweep_pass1`.
    """
    n = xyz.shape[0]
    p = _sweep_pass1(
        xyz,
        valid,
        cell_size,
        k=k,
        wr=wr,
        per_seg=per_seg,
        table_size=table_size,
        prebuilt=prebuilt,
    )
    kp1 = k + 1
    planar = p["planar"]
    use_s = p["use_s"]
    nall = use_s.shape[0]

    # Compacted rescue in the SORTED frame: flagged queries are packed
    # into a few dense 128-query blocks (spatially coherent — tight AABBs,
    # deep pruning), rescued against the AABB-pruned resident cloud, and
    # scattered back into the sorted-frame results; ONE 2-channel unsort
    # then restores row order. (At the KITTI operating point flagged
    # queries spread over ~every block, so an in-place per-block rescue
    # would pay a ~100-row group walk in each block; compaction
    # concentrates that cost into flagged/128 blocks.)
    flagged_s = jnp.logical_and(use_s, jnp.logical_not(p["point_ok_s"]))
    radius = rescue_cells * cell_size
    # Rows with >= want candidates found, an uncertifiable kth AND a
    # large upper-bound mean carry NO decision certificate from pass 1
    # (count-short rows get the count lower bound; small-UB rows certify
    # their keep directly) — when flagged exceeds fix_cap, rescue these
    # FIRST so every row ends up decision-certifiable. The 2-cell mean
    # gate is a slot-saving heuristic only (any practical keep threshold
    # is above it); the certificate itself is re-checked post-hoc.
    hard_s = (
        jnp.logical_and(
            jnp.logical_and(
                flagged_s,
                p["count_s"] >= p["want"].astype(jnp.float32),
            ),
            p["mean_s"] > 2.0 * cell_size,
        )
        if with_lb
        else None
    )
    planar_g, q_planar, active, qvalid, qsel = _rescue_structure(
        planar, None, flagged_s, fix_cap, nall, radius, priority=hard_s
    )
    rtotal, rcount, rkth, rseg_ok = _rescue_select_xla(
        planar_g, q_planar, active, k=kp1,
        per_seg=(5 if with_lb else 3), gr=RESCUE_GROUP_ROWS,
    )
    rcount_f = rcount.astype(jnp.float32)

    # ── Rescue means + certificates ──
    wantf = p["want"].astype(jnp.float32)
    n_neighbors = jnp.maximum(rcount_f - 1.0, 0.0)
    rmean = jnp.where(
        n_neighbors > 0,
        rtotal / jnp.maximum(n_neighbors, 1.0),
        jnp.inf,
    )
    rmean = jnp.where(rcount_f >= wantf, rmean, jnp.inf)
    r2_cert = _rescue_cert_r2(radius)
    rok = jnp.logical_and(rcount_f >= wantf, rkth <= r2_cert)
    rok = jnp.logical_and(rok, rseg_ok)
    rok = jnp.logical_and(rok, qvalid)
    rok = jnp.logical_and(rok, jnp.logical_not(p["table_overflow"]))

    # ── Scatter back into the sorted frame (qsel ARE sorted positions) ──
    pos = jnp.where(qvalid, qsel, nall)  # drop non-flagged slots
    if not with_lb:
        mean_s = p["mean_s"].at[pos].set(
            jnp.where(qvalid, rmean, 0.0), mode="drop"
        )
        ok_s = p["point_ok_s"].at[pos].set(
            jnp.where(qvalid, rok, False), mode="drop"
        )
        # Flagged rows beyond fix_cap were never selected and stay
        # point_ok=False, so `certified` already reflects rescue overflow.
        certified = jnp.logical_not(
            jnp.any(jnp.logical_and(use_s, jnp.logical_not(ok_s)))
        )
        mean, point_ok = _unsort_mean_ok(mean_s, ok_s, p["inv"], n)
        return mean, point_ok, certified

    # ── Per-row LOWER BOUND on the true mean neighbor distance ──
    # Candidate sets are provably COMPLETE within a known radius R (the
    # per-query coverage radius in pass 1; the rescue prune radius in
    # pass 2), wherever the window/selection machinery certified. Two
    # sound bounds, combined by max:
    #  * count-short (count < want): the missing (want - count) true
    #    neighbors are each > R:
    #    true_mean >= (total + (want - count) * R) / (want - 1).
    #  * m-bound (count >= want, kth > R): found distances <= R are the
    #    true ones; each of the (at most want-1) found beyond R
    #    over-estimates its true counterpart by at most (kth - R):
    #    true_mean >= mean_found - (kth - R).
    # Consumers use this for the keep-DECISION certificate: UB <= thr
    # proves keep, LB > thr proves removal (pipelines/kitti.py) — the
    # isolated-point argument folded into the certificate.
    wantf = p["want"].astype(jnp.float32)
    ndiv = jnp.maximum(wantf - 1.0, 1.0)
    safe1 = jnp.sqrt(p["safe2_s"])
    mok = p["machine_ok_s"]
    short1 = p["count_s"] < wantf
    lb1_short = jnp.where(
        jnp.logical_and(mok, short1),
        (p["total_s"] + (wantf - p["count_s"]) * safe1) / ndiv,
        0.0,
    )
    kthd1 = jnp.sqrt(jnp.maximum(p["kth_s"], 0.0))
    lb1_m = jnp.where(
        jnp.logical_and(mok, jnp.logical_not(short1)),
        p["mean_s"] - jnp.maximum(kthd1 - safe1, 0.0),
        0.0,
    )
    lb1 = jnp.maximum(lb1_short, jnp.maximum(lb1_m, 0.0))
    # Exact rows: lb = the exact mean itself.
    lb1 = jnp.where(p["point_ok_s"], p["mean_s"], lb1)
    rshort = rcount_f < wantf
    rlb_short = jnp.where(
        jnp.logical_and(rseg_ok, rshort),
        (rtotal + (wantf - rcount_f) * radius) / ndiv,
        0.0,
    )
    rkthd = jnp.sqrt(jnp.maximum(rkth, 0.0))
    rlb_m = jnp.where(
        jnp.logical_and(rseg_ok, jnp.logical_not(rshort)),
        jnp.where(jnp.isfinite(rmean), rmean, 0.0)
        - jnp.maximum(rkthd - radius, 0.0),
        0.0,
    )
    rlb = jnp.maximum(rlb_short, jnp.maximum(rlb_m, 0.0))
    rlb = jnp.where(rok, jnp.where(jnp.isfinite(rmean), rmean, 0.0), rlb)

    # ONE packed 3-channel scatter (the three separate .at[].set calls
    # each re-stream the row arrays).
    base = jnp.stack(
        [p["mean_s"], p["point_ok_s"].astype(jnp.float32), lb1]
    )
    upd = jnp.stack(
        [
            jnp.where(qvalid, rmean, 0.0),
            jnp.where(qvalid, rok.astype(jnp.float32), 0.0),
            jnp.where(qvalid, rlb, 0.0),
        ]
    )
    merged = base.at[:, pos].set(upd, mode="drop")
    mean_s = merged[0]
    ok_s = merged[1] > 0.5
    lb_s = merged[2]
    # Flagged rows beyond fix_cap were never selected and stay
    # point_ok=False, so `certified` already reflects rescue overflow.
    certified = jnp.logical_not(
        jnp.any(jnp.logical_and(use_s, jnp.logical_not(ok_s)))
    )
    mean, point_ok = _unsort_mean_ok(mean_s, ok_s, p["inv"], n)
    if p["inv"] is None:
        lb = lb_s[:n]
    else:
        lb = jnp.take(lb_s, p["inv"])
    return mean, point_ok, certified, lb


def _rescue_structure(planar, order, flagged, fix_cap: int, n: int, radius,
                      q_src=None, priority=None):
    """Shared pass-2 front end: compact flagged queries (in SORTED order,
    so blocks are spatially coherent and AABBs tight), pad the planar
    array to rescue groups, and build per-block AABB-pruned active-group
    lists for `_rescue_select_xla` / `_rescue_knn_xla`.

    ``q_src``: planar frame to read QUERY coordinates from (default:
    ``planar`` itself — the same-cloud rescues, where queries are rows of
    the candidate frame). The cross-cloud sweep passes its separately
    sorted query frame; ``order``/``flagged``/``n`` are then the QUERY
    side's sort order / flags / count, while ``planar`` stays the
    candidate (point) frame the AABB groups are built over.

    Returns (planar_g, q_planar [QB,4,128], active i32[QB,1+NG],
    qvalid bool[qcap], qsel i32[qcap] — sorted-frame positions)."""
    from ..core.cloud import compaction_order

    nrows = planar.shape[0]
    gr = RESCUE_GROUP_ROWS
    # planar rows are padded to >= wr; pad further to a group multiple.
    gpad = (-nrows) % gr
    if gpad:
        planar_g = jnp.concatenate(
            [planar, jnp.zeros((gpad, 4, 128), jnp.float32)], axis=0
        )
    else:
        planar_g = planar
    ng = planar_g.shape[0] // gr

    # Pack flagged queries in SORTED order: spatially coherent blocks give
    # tight AABBs and deep pruning. order=None: rows already sorted.
    flagged_sorted = flagged if order is None else jnp.take(flagged, order)
    if priority is not None:
        # Rescue HIGH-priority rows first when flagged > fix_cap (e.g.
        # rows with no lower-bound decision certificate); within each
        # class, sorted order keeps blocks spatially coherent.
        prio_sorted = (
            priority if order is None else jnp.take(priority, order)
        )
        nq = flagged_sorted.shape[0]
        key = jnp.where(
            flagged_sorted,
            jnp.where(prio_sorted, jnp.int32(0), jnp.int32(1)),
            jnp.int32(2),
        )
        _, fq = jax.lax.sort(
            (key, jnp.arange(nq, dtype=jnp.int32)), num_keys=1,
            is_stable=True,
        )
    else:
        fq = compaction_order(flagged_sorted)
    # Clamp the rescue capacity to the (128-rounded) cloud size: small
    # clouds otherwise under-fill the query blocks. fix_cap itself must
    # land on a 128-row block boundary (the reshape below is [qb, 128]),
    # so round it up rather than requiring callers to know the rule.
    fix_cap = ((fix_cap + 127) // 128) * 128
    qcap = min(fix_cap, ((n + 127) // 128) * 128)
    qsel = fq[: min(qcap, n)].astype(jnp.int32)
    if qcap > n:
        qsel = jnp.concatenate([qsel, jnp.zeros((qcap - n,), jnp.int32)])
    qvalid = jnp.take(flagged_sorted, qsel)
    if qcap > n:
        qvalid = jnp.logical_and(
            qvalid, jnp.arange(qcap, dtype=jnp.int32) < n
        )

    qf = planar if q_src is None else q_src
    chan = lambda c: qf[:, c, :].reshape(-1)  # noqa: E731
    qx = jnp.take(chan(0), qsel)
    qy = jnp.take(chan(1), qsel)
    qz = jnp.take(chan(2), qsel)
    qb = qcap // 128
    q_planar = jnp.stack(
        [
            qx.reshape(qb, 128),
            qy.reshape(qb, 128),
            qz.reshape(qb, 128),
            qvalid.astype(jnp.float32).reshape(qb, 128),
        ],
        axis=1,
    )  # [QB, 4, 128]

    # ── AABB prune mask ──
    big = jnp.float32(jnp.inf)
    gw = planar_g[:, 3, :].reshape(ng, -1) > 0.5  # [NG, gr*128]

    def gminmax(c):
        v = planar_g[:, c, :].reshape(ng, -1)
        return (
            jnp.min(jnp.where(gw, v, big), axis=1),
            jnp.max(jnp.where(gw, v, -big), axis=1),
        )

    gxn, gxx = gminmax(0)
    gyn, gyx = gminmax(1)
    gzn, gzx = gminmax(2)

    qv = qvalid.reshape(qb, 128)

    def qminmax(a):
        v = a.reshape(qb, 128)
        return (
            jnp.min(jnp.where(qv, v, big), axis=1),
            jnp.max(jnp.where(qv, v, -big), axis=1),
        )

    qxn, qxx = qminmax(qx)
    qyn, qyx = qminmax(qy)
    qzn, qzx = qminmax(qz)

    def gap(qn, qx_, gn, gx_):
        return jnp.maximum(
            0.0,
            jnp.maximum(qn[:, None] - gx_[None, :], gn[None, :] - qx_[:, None]),
        )

    gap2 = (
        gap(qxn, qxx, gxn, gxx) ** 2
        + gap(qyn, qyx, gyn, gyx) ** 2
        + gap(qzn, qzx, gzn, gzx) ** 2
    )  # [QB, NG]
    # fp guard: prune strictly OUTSIDE an inflated ball; certify strictly
    # INSIDE a deflated one. Empty groups/blocks give gap = +inf - -inf
    # = nan-free (+inf) and prune away.
    r2_prune = (radius * 1.00001) ** 2 + 1e-6
    keep = gap2 <= r2_prune  # [QB, NG]
    keep = jnp.where(jnp.isnan(gap2), False, keep)
    # (dtype pinned: jnp.sum would promote i32 to i64 under x64.)
    counts = jnp.sum(keep.astype(jnp.int32), axis=1).astype(jnp.int32)
    # Ascending active-group lists (False sorts after True with stable
    # argsort on ~keep).
    act = jnp.argsort(jnp.logical_not(keep), axis=1, stable=True).astype(
        jnp.int32
    )
    active = jnp.concatenate([counts[:, None], act], axis=1)  # [QB, 1+NG]
    return planar_g, q_planar, active, qvalid, qsel


def _rescue_cert_r2(radius):
    """Shared certification radius: strictly INSIDE the (inflated) prune
    ball, so fp rounding can never certify an uncovered neighbor."""
    return (radius * 0.99999) ** 2


def _rescue_rows_orig(order, qsel, n):
    """Original row ids of the compacted rescue queries (n = drop slot).
    order=None (identity permutation): sorted positions ARE row ids."""
    if order is None:
        return jnp.minimum(qsel, n)
    return jnp.take(
        jnp.concatenate(
            [order.astype(jnp.int32), jnp.full((1,), n, jnp.int32)]
        ),
        jnp.minimum(qsel, n),
    )


def _rescue_block_d2(planar_g, gr: int):
    """Shared scaffold for the rescue selections: flattens the grouped
    planar candidate columns once and returns a per-block function
    mapping (act i32[1+NG], qrow f32[4, 128]) -> (d2 f32[128, NC],
    candmask bool[NC]) with the active-group mask applied (the fourth
    q channel differs per op: validity bit vs r², so it is left to the
    caller)."""
    ng = planar_g.shape[0] // gr
    cx = planar_g[:, 0, :].reshape(-1)
    cy = planar_g[:, 1, :].reshape(-1)
    cz = planar_g[:, 2, :].reshape(-1)
    cw = planar_g[:, 3, :].reshape(-1) > 0.5

    def masked_d2(act, qrow):
        cnt, idx = act[0], act[1:]
        gmask = (
            jnp.zeros((ng,), bool)
            .at[jnp.where(jnp.arange(ng) < cnt, idx, ng)]
            .set(True, mode="drop")
        )
        candmask = jnp.logical_and(cw, jnp.repeat(gmask, gr * 128))
        qx, qy, qz = qrow[0], qrow[1], qrow[2]
        d2 = (
            (qx[:, None] - cx[None, :]) ** 2
            + (qy[:, None] - cy[None, :]) ** 2
            + (qz[:, None] - cz[None, :]) ** 2
        )
        return d2, candmask

    return masked_d2


def _rescue_select_xla(planar_g, q_planar, active, *, k: int, per_seg: int,
                       gr: int):
    """Rescue selection: segmented k-smallest over each query block's
    AABB-pruned active candidate groups."""
    masked_d2 = _rescue_block_d2(planar_g, gr)

    def block_fn(args):
        act, qrow = args  # act i32[1+NG], qrow f32[4, 128]
        d2, candmask = masked_d2(act, qrow)
        qm = qrow[3] > 0.5
        v = jnp.logical_and(qm[:, None], candmask[None, :])
        return _segmented_smallest_k(d2, v, k, per_seg=per_seg)

    totals, counts, kths, oks = jax.lax.map(block_fn, (active, q_planar))
    return (
        totals.reshape(-1),
        counts.reshape(-1),
        kths.reshape(-1),
        oks.reshape(-1),
    )


def cluster_cell_size(radius, hi_abs):
    """Sort-cell width for cluster sweeps: one cluster radius plus the f32
    floor-rounding margin (scaled by the largest absolute coordinate), so
    the 27-cell neighborhood provably contains every within-radius
    candidate."""
    return radius * 1.00002 + hi_abs * 6e-7 + 1e-7


@partial(
    jax.jit,
    static_argnames=(
        "wr", "max_iters", "jumps", "table_size", "rep_labels",
    ),
)
def sweep_cluster_labels(
    xyz,
    valid,
    radius,
    *,
    wr: int = 7,
    max_iters: int = 64,
    jumps: int = 2,
    table_size: int = SWEEP_TABLE_SIZE,
    rep_labels: bool = True,
):
    """Euclidean-cluster labels by sweep min-label propagation.

    Connected components under inclusive distance ``radius``, computed by
    iterated min-label hops over the cell-sorted windows
    (`_cluster_propagate_xla`) with a root hook and two pointer-jumping
    rounds between hops — converges in 3-5 iterations on automotive scenes.

    Returns (labels i32[N], exact bool[]): labels in ORIGINAL point order,
    label = smallest original row in the component (invalid/non-finite
    points keep their own row) — the `cellgrid.cell_graph_labels` contract.
    ``exact`` is False when any block's windows overflowed (a candidate
    neighborhood was truncated, so components may be under-merged) or the
    iteration cap was hit; callers must then fall back to an exact path.
    """
    n = xyz.shape[0]
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    use_pre = jnp.logical_and(valid, finite)

    hi_abs = jnp.max(jnp.where(use_pre[:, None], jnp.abs(xyz), 0.0))
    cell_size = cluster_cell_size(radius, hi_abs)

    s = _sorted_structure(xyz, valid, cell_size, wr, table_size)
    planar = s["planar"]
    starts_skip = s["starts_skip"]
    use = s["use"]
    nrows, nb = s["nrows"], s["nb"]
    nall = nrows * 128
    suse_p = planar[:, 3, :].reshape(-1) > 0.5

    exact = jnp.logical_and(
        jnp.all(s["block_ok"][:nb]), jnp.logical_not(s["table_overflow"])
    )

    r2 = jnp.float32(radius) * jnp.float32(radius)

    base6 = jnp.concatenate(
        [
            planar,  # [x, y, z, w]
            jnp.zeros((nrows, 1, 128), jnp.float32),  # label (per iteration)
            jnp.full((nrows, 1, 128), r2, jnp.float32),
            jnp.zeros((nrows, 2, 128), jnp.float32),
        ],
        axis=1,
    )  # [NR, 8, 128]

    lab0 = jnp.arange(nall, dtype=jnp.int32)

    # Frontier tracking: per-block window read ranges for the
    # active-block computation (a block whose window rows saw no label
    # change since its last evaluation would reproduce its previous
    # result exactly, so the hop passes it through untouched).
    st_c = starts_skip[:, :NSHIFT]
    lo_rows = jnp.minimum(st_c + starts_skip[:, NSHIFT : 2 * NSHIFT], nrows)
    hi_rows = jnp.minimum(
        st_c + starts_skip[:, 2 * NSHIFT : 3 * NSHIFT], nrows
    )

    def hop(lab_f, starts_it):
        return _cluster_propagate_xla(
            base6.at[:, 4, :].set(lab_f.reshape(nrows, 128)),
            starts_it,
            wr=wr,
        )

    def body(state):
        lab, active, _, it = state
        starts_it = jnp.concatenate(
            [starts_skip, active.astype(jnp.int32)[:, None]], axis=1
        )
        newq, changed = hop(lab.astype(jnp.float32), starts_it)
        m = newq.astype(jnp.int32)
        if nall > nb * 128:
            m = jnp.concatenate([m, lab[nb * 128 :]])
        new = jnp.minimum(lab, m)
        # HOOK (Shiloach-Vishkin style): each point's discovery also
        # updates its current root's label via scatter-min, so label trees
        # merge at the roots and pointer jumping then compresses them —
        # gather-only hops spread the min one graph edge per iteration
        # (diameter-bound: 22 iterations on aerial blobs), hop+hook+jump
        # converges in O(log): 5 on the same scene.
        new = new.at[jnp.clip(lab, 0, nall - 1)].min(m)
        # Pointer jumping (labels are sorted positions): each jump
        # squares the compression reach, so `jumps` trades one gather
        # per jump against the hop count (a full window pass each).
        for _ in range(jumps):
            new = jnp.minimum(
                new, jnp.take(new, jnp.clip(new, 0, nall - 1))
            )
        # Next frontier: blocks whose windows contain any changed row
        # (includes hook/jump-induced changes — diff over the FINAL
        # labels).
        diff_rows = jnp.max(
            (new != lab).reshape(nrows, 128).astype(jnp.int32), axis=1
        )
        cum = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(diff_rows)]
        )
        win_any = jnp.take(cum, hi_rows) - jnp.take(cum, lo_rows)
        new_active = jnp.any(win_any > 0, axis=1)
        any_changed = jnp.sum(changed) > 0.5
        return new, new_active, any_changed, it + 1

    def cond(state):
        _, _, changed, it = state
        return jnp.logical_and(changed, it < max_iters)

    lab, _, still_changed, iters = jax.lax.while_loop(
        cond,
        body,
        (lab0, jnp.ones((nb,), bool), jnp.asarray(True), jnp.int32(0)),
    )
    exact = jnp.logical_and(exact, iters < max_iters)
    return _cluster_epilogue(lab, s, use, suse_p, n, nall, exact, rep_labels)


def _cluster_epilogue(lab, s, use, suse_p, n, nall, exact,
                      rep_labels: bool = True):
    """Sorted-position labels -> original-order representative labels.

    Representative = smallest ORIGINAL row in the component (the
    cell_graph_labels contract). order maps sorted position -> original
    row for positions < n.

    ``rep_labels=False`` returns CANONICAL component ids instead: the
    smallest sorted position in the component, mapped back to original
    order. Component identity (which points share a label) is identical
    and deterministic; only the label VALUES differ from the
    cell_graph_labels contract. This skips a 262K-scale scatter-min
    and is what the fused pipelines use — their
    extract_clusters groups by label value without interpreting it.
    Invalid/non-finite points still get a unique singleton id (their own
    sorted position, offset so it can never collide with a component
    id... they cannot collide anyway: every label is a sorted position,
    and each position belongs to exactly one point)."""
    order = s["order"]
    if not rep_labels:
        plab = jnp.take(lab[:n], s["inv"])
        # Invalid rows: unique ids offset past every sorted position so
        # they can never collide with a component id.
        own = jnp.arange(nall, nall + n, dtype=jnp.int32)
        labels = jnp.where(use, plab, own)
        return labels, exact
    order_rows = jnp.concatenate(
        [
            order.astype(jnp.int32),
            jnp.full((nall - n,), n, jnp.int32),
        ]
    )
    min_row = (
        jnp.full((nall + 1,), n, jnp.int32)
        .at[jnp.where(suse_p, lab, nall)]
        .min(order_rows, mode="drop")
    )
    rep_sorted = jnp.take(min_row, jnp.clip(lab, 0, nall - 1))  # [nall]

    plab = jnp.take(rep_sorted[:n], s["inv"])
    own = jnp.arange(n, dtype=jnp.int32)
    labels = jnp.where(jnp.logical_and(use, plab < n), plab, own)
    return labels, exact


def _cluster_propagate_xla(planar8, starts_skip, *, wr: int):
    """One min-label hop over the windows ([3S+2] starts pack: the last
    two columns are the block's valid and active flags; inactive or
    invalid blocks pass labels through)."""
    nb = starts_skip.shape[0]
    nshift = (starts_skip.shape[1] - 2) // 3
    biglab = jnp.float32(float(1 << 25))

    def block_fn(args):
        ss, qrow = args
        st = ss[:nshift]
        ln = ss[2 * nshift : 3 * nshift]
        run = jnp.logical_and(
            ss[3 * nshift] != 0, ss[3 * nshift + 1] != 0
        )
        qx, qy, qz = qrow[0], qrow[1], qrow[2]
        qm = qrow[3] > 0.5
        qlab = qrow[4]
        r2 = qrow[5][0]

        def win_fn(s):
            return jax.lax.dynamic_slice(
                planar8, (s, jnp.int32(0), jnp.int32(0)), (wr, 8, 128)
            )

        wins = jax.vmap(win_fn)(st)  # [9, wr, 8, 128]
        rr = jnp.arange(wr, dtype=jnp.int32)[None, :]
        rkeep = (rr < ln[:, None])[:, :, None]  # length mask (skip unused
        # for min-propagation: duplicated candidates are harmless to min)
        cx = wins[:, :, 0, :].reshape(-1)
        cy = wins[:, :, 1, :].reshape(-1)
        cz = wins[:, :, 2, :].reshape(-1)
        cw = jnp.logical_and(wins[:, :, 3, :] > 0.5, rkeep).reshape(-1)
        clab = wins[:, :, 4, :].reshape(-1)
        d2 = (
            (qx[:, None] - cx[None, :]) ** 2
            + (qy[:, None] - cy[None, :]) ** 2
            + (qz[:, None] - cz[None, :]) ** 2
        )
        within = jnp.logical_and(
            jnp.logical_and(qm[:, None], cw[None, :]), d2 <= r2
        )
        best = jnp.min(
            jnp.where(within, clab[None, :], biglab), axis=1
        )
        best = jnp.where(qm, jnp.minimum(best, qlab), biglab)
        changed = jnp.logical_and(qm, best < qlab).astype(jnp.float32)
        best = jnp.where(run, best, qlab)
        changed = jnp.where(run, changed, 0.0)
        return best, changed

    labs, changed = jax.lax.map(block_fn, (starts_skip, planar8[:nb]))
    return labs.reshape(-1), changed.reshape(-1)


def _sorted_structure(xyz, valid, cell_size, wr, table_size):
    """Sort, pack, and window-compute: the shared front half of every sweep
    (SOR pass 1, clustering, moments, KNN, radius count all route here).

    Returns a dict with the planar array, permutation, window starts, and
    grid metadata."""
    n = xyz.shape[0]
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    use = jnp.logical_and(valid, finite)

    c = jnp.floor(xyz / cell_size)
    c = jnp.clip(c, -1e9, 1e9).astype(jnp.int32)
    big32 = jnp.int32(2**30)
    mn = jnp.min(jnp.where(use[:, None], c, big32), axis=0)
    mn = jnp.minimum(mn, big32 - 1)
    rel = jnp.clip(c - mn[None, :], 0, None)
    mx = jnp.max(jnp.where(use[:, None], rel, 0), axis=0)
    extent = mx + 1
    ext64 = extent.astype(jnp.int64)
    lin64 = (
        rel[:, 0].astype(jnp.int64) * ext64[1] + rel[:, 1].astype(jnp.int64)
    ) * ext64[2] + rel[:, 2].astype(jnp.int64)
    table_overflow = (ext64[0] * ext64[1] * ext64[2]) > table_size
    lin = jnp.where(use, jnp.clip(lin64, 0, table_size - 1), table_size).astype(
        jnp.int32
    )

    # Payload-carrying stable sort: x/y/z and the original row id ride the
    # cell-key sort as 1-D channels, and the inverse permutation is one
    # more key-value sort (no [N, 3] row gather, no scatter-built inverse).
    iota = jnp.arange(n, dtype=jnp.int32)
    slin, sxc, syc, szc, order = jax.lax.sort(
        (lin, xyz[:, 0], xyz[:, 1], xyz[:, 2], iota),
        num_keys=1,
        is_stable=True,
    )
    suse = slin < table_size
    sxc = jnp.where(suse, sxc, 0.0)
    syc = jnp.where(suse, syc, 0.0)
    szc = jnp.where(suse, szc, 0.0)

    pad = (-n) % 128
    npad = n + pad
    nrows = max(npad // 128, wr)
    tail = nrows * 128 - n
    if tail:
        ftail = jnp.zeros((tail,), jnp.float32)
        slin_p = jnp.concatenate(
            [slin, jnp.full((tail,), table_size, jnp.int32)]
        )
        sxc_p = jnp.concatenate([sxc, ftail])
        syc_p = jnp.concatenate([syc, ftail])
        szc_p = jnp.concatenate([szc, ftail])
        suse_p = jnp.concatenate([suse, jnp.zeros((tail,), bool)])
    else:
        slin_p, sxc_p, syc_p, szc_p, suse_p = slin, sxc, syc, szc, suse
    nb = npad // 128

    planar = jnp.stack(
        [
            sxc_p.reshape(nrows, 128),
            syc_p.reshape(nrows, 128),
            szc_p.reshape(nrows, 128),
            suse_p.astype(jnp.float32).reshape(nrows, 128),
        ],
        axis=1,
    )

    starts_skip, block_ok = _window_starts(
        slin_p, suse_p, extent, nrows, nb, wr, table_size
    )
    _, inv = jax.lax.sort((order, iota), num_keys=1, is_stable=True)
    return dict(
        planar=planar,
        order=order,
        inv=inv,
        use=use,
        starts_skip=starts_skip,
        block_ok=block_ok,
        mn=mn,
        extent=extent,
        nrows=nrows,
        nb=nb,
        table_overflow=table_overflow,
        slin_p=slin_p,
        suse_p=suse_p,
    )


@partial(
    jax.jit,
    static_argnames=("k", "wr", "per_seg", "table_size"),
)
def sweep_knn_moments_rows(
    xyz,
    valid,
    cell_size,
    *,
    k: int,
    wr: int = 4,
    per_seg: int = 3,
    table_size: int = SWEEP_TABLE_SIZE,
    prebuilt=None,
):
    """Row-layout KNN moments: (m1 f32[3, N], m2 f32[6, N] (xx, yy, zz,
    xy, xz, yz), count f32[N], point_ok bool[N]). Same semantics as
    `sweep_knn_moments`; the fused pipelines consume the rows directly so
    no [N, 3]/[N, 6] tile-padded intermediates are ever materialized.

    ``prebuilt``: a `structure_from_sorted` dict — skips the sort/pack/
    window phase AND the unsort (results come back in row order).
    """
    s = prebuilt if prebuilt is not None else _sorted_structure(
        xyz, valid, cell_size, wr, table_size
    )
    return _moments_pass1(
        s, cell_size, k=k, wr=wr, per_seg=per_seg,
    )


def _moments_pass1(s, cell_size, *, k: int, wr: int, per_seg: int):
    out = _sweep_moments_xla(
        s["planar"], s["starts_skip"], k=k, wr=wr, per_seg=per_seg
    )

    ok_sorted = jnp.logical_and(
        out[12] > 0.5, jnp.repeat(s["block_ok"], 128)
    )
    ok_sorted = jnp.logical_and(ok_sorted, out[9] == out[10])  # tie-free

    n = s["use"].shape[0]
    if s["inv"] is None:
        # Identity permutation: results already in row order.
        res = jnp.concatenate(
            [out[0:9], out[10:12], ok_sorted[None].astype(jnp.float32)],
            axis=0,
        )[:, :n]
    else:
        # Single packed unsort: one gather with [12, 1] slices instead of
        # twelve separate 4-byte-slice gathers.
        packed = jnp.concatenate(
            [out[0:9], out[10:12], ok_sorted[None].astype(jnp.float32)],
            axis=0,
        )  # [12, npad]
        res = jnp.take(packed, s["inv"], axis=1)  # [12, n]

    count = res[9]
    kth = res[10]
    point_ok = res[11] > 0.5

    # kth-within-cell certificate (same margin as the SOR sweep).
    if s.get("hi_cells") is not None:
        hi_cells = s["hi_cells"]
    else:
        hi_cells = jnp.max(
            jnp.maximum(
                jnp.abs(s["mn"]), jnp.abs(s["mn"] + s["extent"])
            ).astype(jnp.float32)
        )
    margin = (hi_cells * 4.0 * 1.2e-7 + 1e-6) * cell_size
    safe = jnp.maximum(cell_size - margin, 0.0)
    point_ok = jnp.logical_and(point_ok, kth <= safe * safe)
    point_ok = jnp.logical_and(point_ok, s["use"])
    point_ok = jnp.logical_and(
        point_ok, jnp.logical_not(s["table_overflow"])
    )
    return res[0:3], res[3:9], count, point_ok


@partial(
    jax.jit,
    static_argnames=("k", "wr", "per_seg", "table_size"),
)
def sweep_knn_moments(
    xyz,
    valid,
    cell_size,
    *,
    k: int,
    wr: int = 4,
    per_seg: int = 3,
    table_size: int = SWEEP_TABLE_SIZE,
):
    """Query-centered moments of each point's k nearest neighbors (self
    included), via the sorted-window sweep.

    Returns (m1 f32[N, 3], m2 f32[N, 6] (xx, yy, zz, xy, xz, yz),
    count f32[N], point_ok bool[N]): sums of (c - q) and its outer product
    over the k nearest neighbors. ``point_ok`` certifies the neighbor set
    is provably the true k nearest AND tie-free at the kth distance
    (count_le == count); flagged rows' moments cover the candidates found
    (callers decide whether that tolerance is acceptable — the aerial
    pipeline validates output parity against the exact engine).
    """
    m1r, m2r, count, point_ok = sweep_knn_moments_rows(
        xyz, valid, cell_size, k=k, wr=wr, per_seg=per_seg,
        table_size=table_size,
    )
    return (
        jnp.transpose(m1r),
        jnp.transpose(m2r),
        count,
        point_ok,
    )


def _sweep_moments_xla(planar, starts_skip, *, k: int, wr: int, per_seg: int):
    """Per-block KNN moments over the windows: segmented k-smallest
    selection, then banded first/second moments of the selected set."""
    nb = starts_skip.shape[0]
    nshift = (starts_skip.shape[1] - 1) // 3

    def block_fn(args):
        ss, qrow = args
        st = ss[:nshift]
        sk = ss[nshift : 2 * nshift]
        ln = ss[2 * nshift : 3 * nshift]
        qx, qy, qz = qrow[0], qrow[1], qrow[2]
        qm = qrow[3] > 0.5

        def win_fn(sv):
            return jax.lax.dynamic_slice(
                planar, (sv, jnp.int32(0), jnp.int32(0)), (wr, 4, 128)
            )

        wins = jax.vmap(win_fn)(st)  # [9, wr, 4, 128]
        rr = jnp.arange(wr, dtype=jnp.int32)[None, :]
        rkeep = jnp.logical_and(rr >= sk[:, None], rr < ln[:, None])
        cx = wins[:, :, 0, :].reshape(-1)
        cy = wins[:, :, 1, :].reshape(-1)
        cz = wins[:, :, 2, :].reshape(-1)
        cw = jnp.logical_and(
            wins[:, :, 3, :] > 0.5, rkeep[:, :, None]
        ).reshape(-1)
        rx = cx[None, :] - qx[:, None]
        ry = cy[None, :] - qy[:, None]
        rz = cz[None, :] - qz[:, None]
        d2 = rx * rx + ry * ry + rz * rz
        v = jnp.logical_and(qm[:, None], cw[None, :])
        total, count, kth, ok = _segmented_smallest_k(d2, v, k, per_seg=per_seg)
        # Banded inclusion: include within kth*(1+D2_BAND), count within
        # kth*(1+3*D2_BAND) — a fused predicate re-derived per consumer is
        # only ~1-ulp reproducible,
        # and the kth candidate sits exactly on the d2 == kth edge, so an
        # exact threshold is nondeterministic. cle > count flags any row
        # with a candidate near enough to kth to matter; certified rows'
        # moments are exactly the true top-k. cle is counted over the FULL
        # candidate width, so a tie squeezed out of a segment's finalists
        # still flags the row.
        kth_hi = kth * jnp.float32(1.0 + D2_BAND)
        kth_hi2 = kth * jnp.float32(1.0 + 3.0 * D2_BAND)
        le = jnp.logical_and(v, d2 <= kth_hi[:, None]).astype(jnp.float32)
        cle = jnp.sum(
            jnp.logical_and(v, d2 <= kth_hi2[:, None]).astype(jnp.float32),
            axis=1,
        )
        m1x = jnp.sum(le * rx, axis=1)
        m1y = jnp.sum(le * ry, axis=1)
        m1z = jnp.sum(le * rz, axis=1)
        mxx = jnp.sum(le * rx * rx, axis=1)
        myy = jnp.sum(le * ry * ry, axis=1)
        mzz = jnp.sum(le * rz * rz, axis=1)
        mxy = jnp.sum(le * rx * ry, axis=1)
        mxz = jnp.sum(le * rx * rz, axis=1)
        myz = jnp.sum(le * ry * rz, axis=1)
        z = jnp.zeros_like(cle)
        return jnp.stack(
            [m1x, m1y, m1z, mxx, myy, mzz, mxy, mxz, myz, cle,
             count.astype(jnp.float32), kth, ok.astype(jnp.float32), z, z, z]
        )

    out = jax.lax.map(block_fn, (starts_skip, planar[:nb]))  # [NB, 16, 128]
    return jnp.transpose(out, (1, 0, 2)).reshape(16, -1)


@partial(
    jax.jit,
    static_argnames=("wr", "table_size"),
)
def sweep_radius_count(
    xyz,
    valid,
    radius,
    *,
    wr: int = 4,
    table_size: int = SWEEP_TABLE_SIZE,
):
    """Count of points within ``radius`` (inclusive, self included) of each
    point, via the sorted-window sweep.

    Returns (counts i32[N], point_ok bool[N]): exact BY CONSTRUCTION for
    certified rows (the sort cell exceeds radius + fp margin, so the
    27-cell neighborhood covers the ball; only window overflow or a table
    overflow can flag a row).
    """
    s = _radius_structure(xyz, valid, radius, wr, table_size)
    counts, point_ok = _radius_pass1(
        s, radius, wr=wr
    )
    return counts, point_ok


def _radius_structure(xyz, valid, radius, wr, table_size):
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    use = jnp.logical_and(valid, finite)
    hi_abs = jnp.max(jnp.where(use[:, None], jnp.abs(xyz), 0.0))
    cell_size = radius * 1.00002 + hi_abs * 6e-7 + 1e-7
    return _sorted_structure(xyz, valid, cell_size, wr, table_size)


def _radius_pass1(s, radius, *, wr: int):
    r2 = jnp.float32(radius) * jnp.float32(radius)
    planar = s["planar"].at[:, 3, :].multiply(r2)  # w: 1 -> r2, 0 stays 0
    counts_f = _count_within_xla(planar, s["starts_skip"], wr=wr)

    ok_sorted = jnp.repeat(s["block_ok"], 128)

    # Single packed unsort (one [2, 1]-slice gather).
    packed = jnp.stack([counts_f, ok_sorted.astype(jnp.float32)])
    res = jnp.take(packed, s["inv"], axis=1)
    counts = res[0].astype(jnp.int32)
    point_ok = jnp.logical_and(res[1] > 0.5, s["use"])
    point_ok = jnp.logical_and(point_ok, jnp.logical_not(s["table_overflow"]))
    counts = jnp.where(s["use"], counts, 0)
    return counts, point_ok


def _count_within_xla(planar, starts_skip, *, wr: int):
    """Per-block within-radius counts over the windows (r² rides the w
    channel; 0 marks invalid rows)."""
    nb = starts_skip.shape[0]
    nshift = (starts_skip.shape[1] - 1) // 3

    def block_fn(args):
        ss, qrow = args
        st = ss[:nshift]
        sk = ss[nshift : 2 * nshift]
        ln = ss[2 * nshift : 3 * nshift]
        qx, qy, qz = qrow[0], qrow[1], qrow[2]
        qm = qrow[3]  # r2 or 0

        def win_fn(sv):
            return jax.lax.dynamic_slice(
                planar, (sv, jnp.int32(0), jnp.int32(0)), (wr, 4, 128)
            )

        wins = jax.vmap(win_fn)(st)
        rr = jnp.arange(wr, dtype=jnp.int32)[None, :]
        rkeep = jnp.logical_and(rr >= sk[:, None], rr < ln[:, None])
        cx = wins[:, :, 0, :].reshape(-1)
        cy = wins[:, :, 1, :].reshape(-1)
        cz = wins[:, :, 2, :].reshape(-1)
        cw = jnp.where(rkeep[:, :, None], wins[:, :, 3, :], 0.0).reshape(-1)
        d2 = (
            (qx[:, None] - cx[None, :]) ** 2
            + (qy[:, None] - cy[None, :]) ** 2
            + (qz[:, None] - cz[None, :]) ** 2
        )
        hit = jnp.logical_and(
            jnp.logical_and(qm[:, None] > 0.0, cw[None, :] > 0.0),
            d2 <= cw[None, :],
        )
        return jnp.sum(hit.astype(jnp.float32), axis=1)

    out = jax.lax.map(block_fn, (starts_skip, planar[:nb]))
    return out.reshape(-1)


@partial(
    jax.jit,
    static_argnames=("k", "wr", "table_size"),
)
def sweep_knn(
    xyz,
    valid,
    cell_size,
    *,
    k: int,
    wr: int = 4,
    table_size: int = SWEEP_TABLE_SIZE,
):
    """All-points KNN (distances + ORIGINAL indices) via the sorted-window
    sweep (`_sweep_knn_xla`).

    Returns (dists f32[N, k] Euclidean ascending (+inf pad),
    idx i32[N, k] (-1 pad), nvalid bool[N, k], point_ok bool[N]).
    Certified rows are exactly the true k nearest (tie ORDER at equal
    distances is first-encountered window order, not the reference
    KD-tree's internal order; distances are identical).
    """
    s = _sorted_structure(xyz, valid, cell_size, wr, table_size)
    n = xyz.shape[0]
    return _knn_pass1(s, n, cell_size, k=k, wr=wr)[:4]


def _knn_pass1(s, n, cell_size, *, k: int, wr: int):
    """Windowed top-k + unsort + certification for the all-points KNN
    sweep. Returns (dists, idx, nvalid, point_ok, want_f) in original
    order (shared by `sweep_knn` and `sweep_knn_two_pass`)."""
    out = _sweep_knn_xla(s["planar"], s["starts_skip"], k=k, wr=wr)

    dists_s = jnp.transpose(out[:k])  # [npad, k]
    pos_s = jnp.transpose(out[k : 2 * k])
    count_s = out[2 * k]
    kth_s = out[2 * k + 1]
    seg_ok_s = out[2 * k + 2] > 0.5
    ok_sorted = jnp.logical_and(seg_ok_s, jnp.repeat(s["block_ok"], 128))

    def unsort(arr):
        return jnp.take(arr[:n], s["inv"], axis=0)

    dists = unsort(dists_s)
    pos = unsort(pos_s)
    count = unsort(count_s)
    kth = unsort(kth_s)
    point_ok = unsort(ok_sorted)

    idx = _positions_to_rows(pos, s["order"], n)
    nvalid = jnp.isfinite(dists)

    hi_cells = jnp.max(
        jnp.maximum(jnp.abs(s["mn"]), jnp.abs(s["mn"] + s["extent"])).astype(
            jnp.float32
        )
    )
    margin = (hi_cells * 4.0 * 1.2e-7 + 1e-6) * cell_size
    safe = jnp.maximum(cell_size - margin, 0.0)
    n_valid_total = jnp.sum(s["use"].astype(jnp.int32))
    want_f = jnp.minimum(k, n_valid_total).astype(jnp.float32)
    point_ok = jnp.logical_and(point_ok, count >= want_f)
    point_ok = jnp.logical_and(point_ok, kth <= safe * safe)
    point_ok = jnp.logical_and(point_ok, s["use"])
    point_ok = jnp.logical_and(point_ok, jnp.logical_not(s["table_overflow"]))
    return dists, idx, nvalid, point_ok, want_f


def _positions_to_rows(pos, order, n):
    """Global sorted-frame positions (f32, -1 pad) -> original row ids."""
    order_pad = jnp.concatenate(
        [order.astype(jnp.int32), jnp.full((1,), -1, jnp.int32)]
    )
    pos_i = jnp.clip(pos.astype(jnp.int32), -1, n - 1)
    return jnp.where(
        pos_i >= 0, jnp.take(order_pad, jnp.clip(pos_i, 0, n - 1)), -1
    )


def _sweep_knn_xla(planar, starts_skip, *, k: int, wr: int, q_planar=None):
    """Per-block windowed top-k with sorted-frame positions (tie ORDER at
    equal distances is top_k's; distances are exact).
    ``q_planar``: separately sorted query frame (cross-cloud); default =
    ``planar`` (the same-cloud sweep, query blocks are the point blocks).
    """
    if q_planar is None:
        q_planar = planar
    nrows = planar.shape[0]
    nb = starts_skip.shape[0]
    nshift = (starts_skip.shape[1] - 1) // 3
    big = jnp.float32(jnp.inf)

    def block_fn(args):
        ss, qrow = args
        st = ss[:nshift]
        sk = ss[nshift : 2 * nshift]
        ln = ss[2 * nshift : 3 * nshift]
        qx, qy, qz = qrow[0], qrow[1], qrow[2]
        qm = qrow[3] > 0.5

        def win_fn(sv):
            return jax.lax.dynamic_slice(
                planar, (sv, jnp.int32(0), jnp.int32(0)), (wr, 4, 128)
            )

        wins = jax.vmap(win_fn)(st)
        rr = jnp.arange(wr, dtype=jnp.int32)[None, :]
        rkeep = jnp.logical_and(rr >= sk[:, None], rr < ln[:, None])
        cx = wins[:, :, 0, :].reshape(-1)
        cy = wins[:, :, 1, :].reshape(-1)
        cz = wins[:, :, 2, :].reshape(-1)
        cw = jnp.logical_and(
            wins[:, :, 3, :] > 0.5, rkeep[:, :, None]
        ).reshape(-1)
        gpos = (
            (st[:, None] + jnp.arange(wr, dtype=jnp.int32)[None, :])[
                :, :, None
            ]
            * 128
            + jnp.arange(128, dtype=jnp.int32)[None, None, :]
        ).reshape(-1)
        d2 = (
            (qx[:, None] - cx[None, :]) ** 2
            + (qy[:, None] - cy[None, :]) ** 2
            + (qz[:, None] - cz[None, :]) ** 2
        )
        w = jnp.where(
            jnp.logical_and(qm[:, None], cw[None, :]), d2, big
        )
        neg_top, arg = jax.lax.top_k(-w, k)
        vals = -neg_top  # [128, k] ascending
        okv = jnp.isfinite(vals)
        pos = jnp.where(okv, jnp.take(gpos, arg), -1)
        count = jnp.sum(okv.astype(jnp.float32), axis=1)
        kth = jnp.where(count >= 1, vals[jnp.arange(128), jnp.clip(count, 1, k).astype(jnp.int32) - 1], 0.0)
        dists = jnp.where(okv, jnp.sqrt(jnp.maximum(vals, 0.0)), big)
        seg_ok = jnp.ones((128,), jnp.float32)  # exact top_k: no segment cert
        return jnp.concatenate(
            [
                jnp.transpose(dists),
                jnp.transpose(pos.astype(jnp.float32)),
                count[None, :],
                kth[None, :],
                seg_ok[None, :],
            ],
            axis=0,
        )

    out = jax.lax.map(block_fn, (starts_skip, q_planar[:nb]))  # [NB, 2k+3, 128]
    return jnp.transpose(out, (1, 0, 2)).reshape(2 * k + 3, -1)


def _rescue_knn_xla(planar_g, q_planar, active, *, k: int, gr: int):
    """Rescue top-k: exact k smallest with positions over each query
    block's active-group candidate set (unconditionally exact over the
    active set, so its segment certificate is always 1)."""
    masked_d2 = _rescue_block_d2(planar_g, gr)

    def block_fn(args):
        act, qrow = args
        d2, candmask = masked_d2(act, qrow)
        qm = qrow[3] > 0.5
        v = jnp.logical_and(qm[:, None], candmask[None, :])
        d2m = jnp.where(v, d2, jnp.inf)
        neg, pos = jax.lax.top_k(-d2m, k)
        dd = -neg  # [128, k] ascending
        found = jnp.isfinite(dd)
        count = jnp.sum(found.astype(jnp.float32), axis=1)
        kth = jnp.max(jnp.where(found, dd, 0.0), axis=1)
        dist = jnp.where(found, jnp.sqrt(jnp.maximum(dd, 0.0)), jnp.inf)
        posf = jnp.where(found, pos.astype(jnp.float32), -1.0)
        return dist, posf, count, kth, jnp.ones((128,), jnp.float32)

    dist, posf, count, kth, seg = jax.lax.map(block_fn, (active, q_planar))
    qn = dist.shape[0] * 128
    return jnp.concatenate(
        [
            jnp.transpose(dist.reshape(-1, k)),  # [k, QN]
            jnp.transpose(posf.reshape(-1, k)),
            count.reshape(1, qn),
            kth.reshape(1, qn),
            seg.reshape(1, qn),
        ],
        axis=0,
    )


@partial(
    jax.jit,
    static_argnames=(
        "k", "fix_cap", "rescue_cells", "wr", "table_size",
    ),
)
def sweep_knn_two_pass(
    xyz,
    valid,
    cell_size,
    *,
    k: int,
    fix_cap: int = 4096,
    rescue_cells: float = 4.0,
    wr: int = 4,
    table_size: int = SWEEP_TABLE_SIZE,
):
    """All-points KNN (distances + ORIGINAL indices): pass-1 sweep + exact
    AABB-group-pruned rescue of flagged queries (the KNN twin of
    `sweep_sor_two_pass`).

    Flagged queries are re-resolved against only the candidate row-groups
    within ``rescue_cells * cell_size`` of their (cell-sorted, coherent)
    query block; a rescued row is certified exact iff its kth distance
    lands strictly inside the rescue ball, its count meets min(k, total),
    and the per-lane squeeze certificate holds. Rows uncertified after
    both passes keep their pass-1 values and point_ok=False (callers fall
    back to a whole-cloud rescue)."""
    n = xyz.shape[0]
    s = _sorted_structure(xyz, valid, cell_size, wr, table_size)
    dists, idx, nvalid, point_ok, want_f = _knn_pass1(
        s, n, cell_size, k=k, wr=wr
    )

    planar = s["planar"]
    order = s["order"]
    use = s["use"]
    flagged = jnp.logical_and(use, jnp.logical_not(point_ok))
    radius = rescue_cells * cell_size
    planar_g, q_planar, active, qvalid, qsel = _rescue_structure(
        planar, order, flagged, fix_cap, n, radius
    )
    rout = _rescue_knn_xla(
        planar_g, q_planar, active, k=k, gr=RESCUE_GROUP_ROWS
    )

    rd = jnp.transpose(rout[:k])  # [qcap, k] Euclidean ascending
    rpos = jnp.transpose(rout[k : 2 * k])
    rcount = rout[2 * k]
    rkth = rout[2 * k + 1]
    rseg_ok = rout[2 * k + 2] > 0.5

    r2_cert = _rescue_cert_r2(radius)
    rok = jnp.logical_and(rcount >= want_f, rkth <= r2_cert)
    rok = jnp.logical_and(rok, rseg_ok)
    rok = jnp.logical_and(rok, qvalid)
    rok = jnp.logical_and(rok, jnp.logical_not(s["table_overflow"]))

    ridx = _positions_to_rows(rpos, order, n)
    rnvalid = jnp.isfinite(rd)

    # Scatter back only CERTIFIED rescues (uncertified rows keep pass-1
    # values and stay flagged for the caller's whole-cloud fallback).
    rows_orig = _rescue_rows_orig(order, qsel, n)
    rows_orig = jnp.where(rok, rows_orig, n)  # drop uncertified slots
    dists = dists.at[rows_orig].set(
        jnp.where(rok[:, None], rd, 0.0), mode="drop"
    )
    idx = idx.at[rows_orig].set(
        jnp.where(rok[:, None], ridx, 0), mode="drop"
    )
    nvalid = nvalid.at[rows_orig].set(
        jnp.where(rok[:, None], rnvalid, False), mode="drop"
    )
    point_ok = point_ok.at[rows_orig].set(rok, mode="drop")
    return dists, idx, nvalid, point_ok


def _sorted_query_frame(qxyz, qvalid, mn, extent, cell_size, table_size):
    """Sort a query set into an EXISTING point grid's cell order (grid
    given by ``mn``/``extent`` from the point cloud's `_sorted_structure`
    at the same ``cell_size``), packing it as a [QB, 4, 128] planar frame
    whose block b sweeps the point windows computed by
    `_window_starts_from_bounds`.

    Valid queries whose cell falls OUTSIDE the point grid cannot be
    served by the ±1-cell windows (their neighborhoods aren't addressable
    in the point table) — they sort to the sentinel tail with w=0 and
    must be rescued (``in_ok`` False). Non-finite query coords are zeroed
    (they are never swept NOR rescued — ``use`` False)."""
    qn = qxyz.shape[0]
    finite = jnp.all(jnp.isfinite(qxyz), axis=-1)
    use = jnp.logical_and(qvalid, finite)
    # Keep REAL coords in the frame for all finite rows (the rescue pass
    # reads flagged query coords from these channels); only zero the
    # non-finite ones so masked lanes can't poison kernel arithmetic.
    qx = jnp.where(finite, qxyz[:, 0], 0.0)
    qy = jnp.where(finite, qxyz[:, 1], 0.0)
    qz = jnp.where(finite, qxyz[:, 2], 0.0)
    c = jnp.floor(qxyz / cell_size)
    c = jnp.clip(c, -1e9, 1e9).astype(jnp.int32)
    rel = c - mn[None, :]
    in_grid = jnp.all(
        jnp.logical_and(rel >= 0, rel < extent[None, :]), axis=1
    )
    inb = jnp.logical_and(use, in_grid)
    relc = jnp.clip(rel, 0, extent[None, :] - 1)
    ext64 = extent.astype(jnp.int64)
    lin64 = (
        relc[:, 0].astype(jnp.int64) * ext64[1]
        + relc[:, 1].astype(jnp.int64)
    ) * ext64[2] + relc[:, 2].astype(jnp.int64)
    lin = jnp.where(
        inb, jnp.clip(lin64, 0, table_size - 1), table_size
    ).astype(jnp.int32)

    iota = jnp.arange(qn, dtype=jnp.int32)
    slin, sx, sy, sz, order = jax.lax.sort(
        (lin, qx, qy, qz, iota), num_keys=1, is_stable=True
    )
    suse = slin < table_size

    tail = (-qn) % 128
    if tail:
        ftail = jnp.zeros((tail,), jnp.float32)
        slin = jnp.concatenate(
            [slin, jnp.full((tail,), table_size, jnp.int32)]
        )
        sx = jnp.concatenate([sx, ftail])
        sy = jnp.concatenate([sy, ftail])
        sz = jnp.concatenate([sz, ftail])
        suse = jnp.concatenate([suse, jnp.zeros((tail,), bool)])
    nb = (qn + tail) // 128

    planar = jnp.stack(
        [
            sx.reshape(nb, 128),
            sy.reshape(nb, 128),
            sz.reshape(nb, 128),
            suse.astype(jnp.float32).reshape(nb, 128),
        ],
        axis=1,
    )
    lo = slin.reshape(nb, 128)[:, 0]
    hi = slin.reshape(nb, 128)[:, -1]
    has_valid = jnp.any(suse.reshape(nb, 128), axis=1)
    _, inv = jax.lax.sort((order, iota), num_keys=1, is_stable=True)
    return dict(
        planar=planar, order=order, inv=inv, use=use, in_ok=inb,
        lo=lo, hi=hi, has_valid=has_valid, nb=nb,
    )


@partial(
    jax.jit,
    static_argnames=(
        "k", "fix_cap", "rescue_cells", "wr", "table_size",
    ),
)
def sweep_knn_cross_two_pass(
    pxyz,
    pvalid,
    qxyz,
    qvalid,
    cell_size,
    *,
    k: int,
    fix_cap: int = 4096,
    rescue_cells: float = 4.0,
    wr: int = 4,
    table_size: int = SWEEP_TABLE_SIZE,
):
    """Cross-cloud KNN (distances + ORIGINAL point indices, per QUERY
    row): the point cloud is sorted/windowed ONCE and the query set is
    sorted into the same cell frame, so arbitrary query batches get the
    single-dispatch sorted-window path instead of a per-call grid
    rebuild. Serves `knn(cloud, other_points, k)`
    — the ICP-adjacent use case (ref: crates/spatial/src/kdtree.rs:64-96
    serves the same calls from one prebuilt KD-tree).

    Same exactness contract as `sweep_knn_two_pass`: per-query
    count/kth/segment certificates on pass 1, AABB-group-pruned exact
    rescue of flagged queries (including valid queries OUTSIDE the point
    grid, whose coords ride the query frame), point_ok=False residuals
    for the caller's whole-cloud fallback.

    Returns (dists f32[Q, k], idx i32[Q, k], nvalid bool[Q, k],
    point_ok bool[Q]) in original query order."""
    pn = pxyz.shape[0]
    qn = qxyz.shape[0]
    sp = _sorted_structure(pxyz, pvalid, cell_size, wr, table_size)
    sq = _sorted_query_frame(
        qxyz, qvalid, sp["mn"], sp["extent"], cell_size, table_size
    )
    starts_skip, block_ok = _window_starts_from_bounds(
        sq["lo"], sq["hi"], sq["has_valid"], sp["slin_p"], sp["suse_p"],
        sp["extent"], sp["nrows"], sp["nb"], wr, table_size,
    )

    out = _sweep_knn_xla(
        sp["planar"], starts_skip, k=k, wr=wr, q_planar=sq["planar"]
    )

    dists_s = jnp.transpose(out[:k])  # [QBpad, k]
    pos_s = jnp.transpose(out[k : 2 * k])
    count_s = out[2 * k]
    kth_s = out[2 * k + 1]
    seg_ok_s = out[2 * k + 2] > 0.5
    ok_sorted = jnp.logical_and(seg_ok_s, jnp.repeat(block_ok, 128))

    def unsort(arr):
        return jnp.take(arr[:qn], sq["inv"], axis=0)

    dists = unsort(dists_s)
    pos = unsort(pos_s)
    count = unsort(count_s)
    kth = unsort(kth_s)
    point_ok = unsort(ok_sorted)

    idx = _positions_to_rows(pos, sp["order"], pn)
    nvalid = jnp.isfinite(dists)

    hi_cells = jnp.max(
        jnp.maximum(
            jnp.abs(sp["mn"]), jnp.abs(sp["mn"] + sp["extent"])
        ).astype(jnp.float32)
    )
    margin = (hi_cells * 4.0 * 1.2e-7 + 1e-6) * cell_size
    safe = jnp.maximum(cell_size - margin, 0.0)
    n_valid_p = jnp.sum(sp["use"].astype(jnp.int32))
    want_f = jnp.minimum(k, n_valid_p).astype(jnp.float32)
    point_ok = jnp.logical_and(point_ok, count >= want_f)
    point_ok = jnp.logical_and(point_ok, kth <= safe * safe)
    point_ok = jnp.logical_and(point_ok, sq["in_ok"])
    point_ok = jnp.logical_and(
        point_ok, jnp.logical_not(sp["table_overflow"])
    )

    # ── In-graph AABB-group-pruned rescue (query coords from sq) ──
    flagged = jnp.logical_and(sq["use"], jnp.logical_not(point_ok))
    radius = rescue_cells * cell_size
    planar_g, q_planar_r, active, rqvalid, qsel = _rescue_structure(
        sp["planar"], sq["order"], flagged, fix_cap, qn, radius,
        q_src=sq["planar"],
    )
    rout = _rescue_knn_xla(
        planar_g, q_planar_r, active, k=k, gr=RESCUE_GROUP_ROWS
    )

    rd = jnp.transpose(rout[:k])  # [qcap, k] Euclidean ascending
    rpos = jnp.transpose(rout[k : 2 * k])
    rcount = rout[2 * k]
    rkth = rout[2 * k + 1]
    rseg_ok = rout[2 * k + 2] > 0.5

    r2_cert = _rescue_cert_r2(radius)
    rok = jnp.logical_and(rcount >= want_f, rkth <= r2_cert)
    rok = jnp.logical_and(rok, rseg_ok)
    rok = jnp.logical_and(rok, rqvalid)
    rok = jnp.logical_and(rok, jnp.logical_not(sp["table_overflow"]))

    ridx = _positions_to_rows(rpos, sp["order"], pn)
    rnvalid = jnp.isfinite(rd)

    rows_orig = _rescue_rows_orig(sq["order"], qsel, qn)
    rows_orig = jnp.where(rok, rows_orig, qn)  # drop uncertified slots
    dists = dists.at[rows_orig].set(
        jnp.where(rok[:, None], rd, 0.0), mode="drop"
    )
    idx = idx.at[rows_orig].set(
        jnp.where(rok[:, None], ridx, 0), mode="drop"
    )
    nvalid = nvalid.at[rows_orig].set(
        jnp.where(rok[:, None], rnvalid, False), mode="drop"
    )
    point_ok = point_ok.at[rows_orig].set(rok, mode="drop")
    return dists, idx, nvalid, point_ok


@partial(
    jax.jit,
    static_argnames=(
        "k", "fix_cap", "rescue_cells", "wr", "per_seg", "table_size",
    ),
)
def sweep_moments_two_pass_rows(
    xyz,
    valid,
    cell_size,
    *,
    k: int,
    fix_cap: int = 4096,
    rescue_cells: float = 4.0,
    wr: int = 4,
    per_seg: int = 3,
    table_size: int = SWEEP_TABLE_SIZE,
):
    """KNN moments with the AABB-group-pruned exact rescue: pass-1 windowed
    moments, then flagged rows re-resolved by `_rescue_knn_xla` (their
    moments recomputed from the rescued neighbor indices — an
    O(fix_cap * k) gather). ROW layout (m1r [3,N], m2r [6,N] in
    xx,yy,zz,xy,xz,yz order, count, point_ok) — the whole rescue stays
    component-planar, so no [N,3]/[...,3] intermediate materializes. Rescued rows are
    certified exact up to kth-distance tie CHOICE (the exact engine's
    brute rescue picks ties the same way), so the tie-free bit pass 1
    demands is not re-imposed here."""
    n = xyz.shape[0]
    s = _sorted_structure(xyz, valid, cell_size, wr, table_size)
    m1r, m2r, count, point_ok = _moments_pass1(
        s, cell_size, k=k, wr=wr, per_seg=per_seg,
    )

    planar = s["planar"]
    order = s["order"]
    use = s["use"]
    flagged = jnp.logical_and(use, jnp.logical_not(point_ok))
    radius = rescue_cells * cell_size
    planar_g, q_planar, active, qvalid, qsel = _rescue_structure(
        planar, order, flagged, fix_cap, n, radius
    )
    rout = _rescue_knn_xla(
        planar_g, q_planar, active, k=k, gr=RESCUE_GROUP_ROWS
    )

    rd = jnp.transpose(rout[:k])  # [qcap, k]
    rpos = jnp.transpose(rout[k : 2 * k])
    rcount = rout[2 * k]
    rkth = rout[2 * k + 1]
    rseg_ok = rout[2 * k + 2] > 0.5

    n_valid_total = jnp.sum(use.astype(jnp.int32))
    want_f = jnp.minimum(k, n_valid_total).astype(jnp.float32)
    r2_cert = _rescue_cert_r2(radius)
    rok = jnp.logical_and(rcount >= want_f, rkth <= r2_cert)
    rok = jnp.logical_and(rok, rseg_ok)
    rok = jnp.logical_and(rok, qvalid)
    rok = jnp.logical_and(rok, jnp.logical_not(s["table_overflow"]))

    # Query-centered moments from the rescued neighbor indices —
    # per-component gathers from the 1-D coordinate columns (a [qcap,k,3]
    # gather would tile-pad its minor axis 3 to 128).
    ridx = _positions_to_rows(rpos, order, n)  # [qcap, k] original rows
    rnb_valid = jnp.isfinite(rd)
    idxc = jnp.clip(ridx, 0, n - 1)
    rows_orig = _rescue_rows_orig(order, qsel, n)
    rowc = jnp.clip(rows_orig, 0, n - 1)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    relx = jnp.where(rnb_valid, jnp.take(x, idxc) - jnp.take(x, rowc)[:, None], 0.0)
    rely = jnp.where(rnb_valid, jnp.take(y, idxc) - jnp.take(y, rowc)[:, None], 0.0)
    relz = jnp.where(rnb_valid, jnp.take(z, idxc) - jnp.take(z, rowc)[:, None], 0.0)
    rm1 = jnp.stack(
        [relx.sum(axis=1), rely.sum(axis=1), relz.sum(axis=1)]
    )  # [3, qcap]
    rm2 = jnp.stack(
        [
            (relx * relx).sum(axis=1),
            (rely * rely).sum(axis=1),
            (relz * relz).sum(axis=1),
            (relx * rely).sum(axis=1),
            (relx * relz).sum(axis=1),
            (rely * relz).sum(axis=1),
        ]
    )  # [6, qcap] — xx,yy,zz,xy,xz,yz, matching pass 1's row order
    rcnt = jnp.sum(rnb_valid.astype(jnp.float32), axis=1)

    # Scatter back only CERTIFIED rescues, along the row layout's point
    # axis (axis 1).
    rows_drop = jnp.where(rok, rows_orig, n)
    m1r = m1r.at[:, rows_drop].set(
        jnp.where(rok[None, :], rm1, 0.0), mode="drop"
    )
    m2r = m2r.at[:, rows_drop].set(
        jnp.where(rok[None, :], rm2, 0.0), mode="drop"
    )
    count = count.at[rows_drop].set(
        jnp.where(rok, rcnt, 0.0), mode="drop"
    )
    point_ok = point_ok.at[rows_drop].set(rok, mode="drop")
    return m1r, m2r, count, point_ok


def _rescue_radius_count_xla(planar_g, q_planar, active, *, gr: int):
    """Rescue within-radius counts over each query block's active groups."""
    masked_d2 = _rescue_block_d2(planar_g, gr)

    def block_fn(args):
        act, qrow = args
        d2, candmask = masked_d2(act, qrow)
        qr2 = qrow[3]  # r² rides the w channel (−1 marks invalid rows)
        hit = jnp.logical_and(candmask[None, :], d2 <= qr2[:, None])
        return jnp.sum(hit.astype(jnp.float32), axis=1)

    return jax.lax.map(block_fn, (active, q_planar)).reshape(-1)


@partial(
    jax.jit,
    static_argnames=("fix_cap", "wr", "table_size"),
)
def sweep_radius_count_two_pass(
    xyz,
    valid,
    radius,
    *,
    fix_cap: int = 4096,
    wr: int = 4,
    table_size: int = SWEEP_TABLE_SIZE,
):
    """Within-radius counts with the AABB-group-pruned exact rescue of
    window-overflow rows. Counting needs no distance certificate (the
    prune ball IS the query radius, so unpruned groups cover every true
    neighbor) — rescued valid rows are exact by construction; only
    fix_cap overflow or a table overflow leaves rows flagged."""
    n = xyz.shape[0]
    s = _radius_structure(xyz, valid, radius, wr, table_size)
    counts, point_ok = _radius_pass1(
        s, radius, wr=wr
    )
    r2 = jnp.float32(radius) * jnp.float32(radius)

    # ── pass 2: pruned rescue of window-overflow rows ──
    flagged = jnp.logical_and(s["use"], jnp.logical_not(point_ok))
    planar_g, q_planar, active, qvalid, qsel = _rescue_structure(
        s["planar"], s["order"], flagged, fix_cap, n, radius
    )
    # r^2 rides the query w channel (-1 marks invalid/padding).
    q_planar = q_planar.at[:, 3, :].set(
        jnp.where(
            q_planar[:, 3, :] > 0.5, r2, jnp.float32(-1.0)
        )
    )

    rcounts = _rescue_radius_count_xla(
        planar_g, q_planar, active, gr=RESCUE_GROUP_ROWS
    )

    rok = jnp.logical_and(qvalid, jnp.logical_not(s["table_overflow"]))
    rows_orig = _rescue_rows_orig(s["order"], qsel, n)
    rows_drop = jnp.where(rok, rows_orig, n)
    counts = counts.at[rows_drop].set(
        jnp.where(rok, rcounts.astype(jnp.int32), 0), mode="drop"
    )
    point_ok = point_ok.at[rows_drop].set(rok, mode="drop")
    return counts, point_ok
