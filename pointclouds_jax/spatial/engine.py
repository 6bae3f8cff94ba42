"""Host-level neighbor engine: picks a backend and certifies exactness.

The cell-grid backend is exact only when its per-query certificates hold
(kth distance safely within one cell width, no block-cap truncation, cell
extents within the dense table). This thin host layer runs the jitted
queries, checks the returned flags (one scalar sync), and retries — growing
the per-cell cap on truncation and the cell on insufficiency — falling back
to tiled brute force (small clouds) or the exact int64 searchsorted engine
(gigantic extents) when the flags won't clear. Every compiled variant is
cached by (padded shape, k, M); the cell size is a dynamic argument, so
cell-only retries cost no recompilation.

This mirrors how the reference guarantees exact KD-tree semantics
(ref: crates/spatial/src/kdtree.rs:64-135) while keeping the fast path fully
batched on the device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .cellgrid import (
    build_cellgrid,
    cell_graph_adjacency,
    cell_graph_labels,
    point_knn,
    point_radius_count,
    slab_knn,
)
from .grid import build_grid
from .knn import (
    bruteforce_knn,
    bruteforce_radius_count,
    grid_knn,
    grid_radius_count,
    grid_radius_neighbors,
    radius_within_mask,
)

# Below this many points the tiled brute-force matmul path is cheaper than
# building a grid (and is unconditionally exact).
BRUTE_THRESHOLD = 2048
M_LADDER = (16, 32, 64, 128)
MAX_TRIES = 4
# The cell grid packs row ids into an f32 channel (exact only below 2^24);
# larger clouds route to the int64 searchsorted engine.
CELLGRID_MAX_N = 1 << 24


@jax.jit
def _extent_device(xyz, valid):
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    use = jnp.logical_and(valid, finite)
    big = jnp.float32(jnp.inf)
    mn = jnp.min(jnp.where(use[:, None], xyz, big), axis=0)
    mx = jnp.max(jnp.where(use[:, None], xyz, -big), axis=0)
    mabs = jnp.max(jnp.where(use[:, None], jnp.abs(xyz), 0.0))
    cnt = jnp.sum(use.astype(jnp.int32))
    return jnp.concatenate([mn, mx, mabs[None], cnt.astype(jnp.float32)[None]])


def _extent(xyz, valid):
    # One 8-scalar transfer instead of shipping the whole cloud to host.
    stats = np.asarray(_extent_device(xyz, valid))
    if stats[7] < 1:
        return None
    return stats[0:3], stats[3:6], float(stats[6]), int(stats[7])


def estimate_cell_size(xyz, valid, k: int) -> float:
    """Initial KNN cell size ~ the expected kth-neighbor distance.

    Blends 3D and 2D (nearly-planar LiDAR) density estimates: for uniform 3D
    density the kth-NN distance is spacing*(3k/4pi)^(1/3); for a plane it is
    spacing2d*sqrt(k/pi). A 1.25x margin avoids one retry in the common
    case; undershoot costs one cell-growth retry, overshoot one cap retry.
    """
    ext = _extent(xyz, valid)
    if ext is None:
        return 1.0
    mn, mx, _, n = ext
    span = np.maximum(mx - mn, 1e-12)
    vol = float(span[0] * span[1] * span[2])
    area = float(np.sort(span)[-2:].prod())  # two largest extents
    s3 = (vol / n) ** (1.0 / 3.0)
    s2 = (area / n) ** 0.5
    kf = max(k, 1)
    r3 = s3 * (3.0 * kf / (4.0 * np.pi)) ** (1.0 / 3.0)
    r2 = s2 * (kf / np.pi) ** 0.5
    return float(max(r3, r2, 1e-9) * 1.25)


def _fp_safe_radius_cell(radius: float, max_abs_coord: float) -> float:
    """Cell size slightly above ``radius`` so that f32 floor(p/cell)
    rounding can never push a true within-radius neighbor outside the
    27-cell neighborhood (the rounding error grows with |coordinate|/cell)."""
    return radius * (1.0 + 1e-5) + max_abs_coord * 6e-7


def _cell_cap(n: int) -> int:
    """Cells never outnumber points; round up to the chunking granularity."""
    return max(2048, -(-n // 2048) * 2048)


def knn(pxyz, pvalid, qxyz, qvalid, k: int):
    """Exact batched KNN: (dists f32[Q,k], idx i32[Q,k], nvalid bool[Q,k]).

    Self-matches are included (a query identical to a stored point returns
    it at distance 0), matching KD-tree behavior.
    """
    n = pxyz.shape[0]
    if k <= 0:
        raise ValueError("k must be >= 1 at the engine level")
    if n <= BRUTE_THRESHOLD or k >= n:
        return bruteforce_knn(pxyz, pvalid, qxyz, qvalid, k)
    if n >= CELLGRID_MAX_N:
        return _knn_int64(pxyz, pvalid, qxyz, qvalid, k)

    if qxyz is pxyz and qvalid is pvalid and k <= 24:
        # Same-cloud all-points KNN: one fused sweep pass + brute rescue of
        # the flagged residual (sparse queries) — no grid builds, no
        # per-retry host syncs.
        out = _knn_sweep_same_cloud(pxyz, pvalid, k)
        if out is not None:
            return out
    elif k <= 24 and qxyz.shape[0] > BRUTE_THRESHOLD:
        # Cross-cloud batches: one sweep structure over the point cloud,
        # queries sorted into its cell frame — single dispatch instead of
        # the per-call grid rebuild below.
        out = _knn_sweep_cross(pxyz, pvalid, qxyz, qvalid, k)
        if out is not None:
            return out

    cell = estimate_cell_size(pxyz, pvalid, k)
    cap = _cell_cap(n)
    m_i = 0
    # Enough block slots that the 27-cell slab can hold k results at all.
    while 27 * M_LADDER[min(m_i, len(M_LADDER) - 1)] < k + 1:
        m_i += 1

    # Pass 1: main grid sized for the typical kth-neighbor radius; grow the
    # per-cell cap only (never the cell — occupancy rises cubically with
    # cell size, so a cell-growth retry ladder can never outrun it).
    grid = None
    for _ in range(MAX_TRIES):
        m = M_LADDER[min(m_i, len(M_LADDER) - 1)]
        g = build_cellgrid(pxyz, pvalid, cell, m_per_cell=m, cell_cap=cap)
        if bool(g.table_overflow):
            return bruteforce_knn(pxyz, pvalid, qxyz, qvalid, k)
        if not bool(g.overflow):
            grid = g
            break
        m_i += 1
    if grid is None:
        return bruteforce_knn(pxyz, pvalid, qxyz, qvalid, k)

    same_cloud = qxyz is pxyz and qvalid is pvalid
    if same_cloud:
        # Rebuild at a tight cell cap (slab size scales with the cap) and
        # take the two-stage slab path: per-cell slabs once, one large
        # slice per point.
        m = M_LADDER[min(m_i, len(M_LADDER) - 1)]
        tight = max(
            2048, 1 << int(np.ceil(np.log2(max(int(grid.num_cells), 1))))
        )
        if tight < cap:
            grid = build_cellgrid(
                pxyz, pvalid, cell, m_per_cell=m, cell_cap=tight
            )
        dists, idx, nvalid, point_ok = slab_knn(grid, qxyz, qvalid, k=k)
    else:
        dists, idx, nvalid, point_ok = point_knn(grid, qxyz, qvalid, k=k)
    flagged = np.asarray(jnp.logical_not(point_ok))
    n_flagged = int(flagged.sum())
    if n_flagged == 0:
        return dists, idx, nvalid

    # Pass 2: re-query only the uncertified minority (sparse/edge queries)
    # against a coarser grid. Coarse occupancy is bounded by growing M with
    # the cell volume; a coarse-grid block truncation would silently corrupt
    # results, so it forces the brute-force pass instead.
    rows = np.nonzero(flagged)[0]
    sub_cap = max(1024, 1 << int(np.ceil(np.log2(max(len(rows), 1)))))
    if sub_cap <= n:  # only worth it when the subset is a real subset
        rows_pad = np.zeros(sub_cap, np.int64)
        rows_pad[: len(rows)] = rows
        sub_valid = np.arange(sub_cap) < len(rows)
        sq = jnp.take(qxyz, jnp.asarray(rows_pad), axis=0)
        sv = jnp.logical_and(
            jnp.take(qvalid, jnp.asarray(rows_pad)), jnp.asarray(sub_valid)
        )
        coarse = build_cellgrid(
            pxyz, pvalid, cell * 2.5, m_per_cell=M_LADDER[-1], cell_cap=cap
        )
        if not bool(coarse.overflow) and not bool(coarse.table_overflow):
            d2_, i2_, v2_, ok2 = point_knn(coarse, sq, sv, k=k)
            dists = dists.at[jnp.asarray(rows_pad)].set(
                jnp.where(sv[:, None], d2_, jnp.take(dists, jnp.asarray(rows_pad), axis=0))
            )
            idx = idx.at[jnp.asarray(rows_pad)].set(
                jnp.where(sv[:, None], i2_, jnp.take(idx, jnp.asarray(rows_pad), axis=0))
            )
            nvalid = nvalid.at[jnp.asarray(rows_pad)].set(
                jnp.where(sv[:, None], v2_, jnp.take(nvalid, jnp.asarray(rows_pad), axis=0))
            )
            still = np.asarray(jnp.logical_and(sv, jnp.logical_not(ok2)))
            rows = rows_pad[np.nonzero(still)[0][: len(rows)]]
            rows = rows[: int(still.sum())]

    # Pass 3: brute force for whatever remains (rare: queries whose true
    # kth neighbor is beyond 2.5x the typical radius).
    if len(rows):
        sub_cap = max(1024, 1 << int(np.ceil(np.log2(len(rows)))))
        rows_pad = np.zeros(sub_cap, np.int64)
        rows_pad[: len(rows)] = rows
        sub_valid = np.arange(sub_cap) < len(rows)
        sq = jnp.take(qxyz, jnp.asarray(rows_pad), axis=0)
        sv = jnp.logical_and(
            jnp.take(qvalid, jnp.asarray(rows_pad)), jnp.asarray(sub_valid)
        )
        d3, i3, v3 = bruteforce_knn(pxyz, pvalid, sq, sv, k)
        dists = dists.at[jnp.asarray(rows_pad)].set(
            jnp.where(sv[:, None], d3, jnp.take(dists, jnp.asarray(rows_pad), axis=0))
        )
        idx = idx.at[jnp.asarray(rows_pad)].set(
            jnp.where(sv[:, None], i3, jnp.take(idx, jnp.asarray(rows_pad), axis=0))
        )
        nvalid = nvalid.at[jnp.asarray(rows_pad)].set(
            jnp.where(sv[:, None], v3, jnp.take(nvalid, jnp.asarray(rows_pad), axis=0))
        )
    return dists, idx, nvalid


def _knn_int64(pxyz, pvalid, qxyz, qvalid, k: int):
    """KNN via the int64 searchsorted grid (spatial/grid.py): the path for
    clouds too large for the cell grid's f32-packed row ids."""
    cell = estimate_cell_size(pxyz, pvalid, k)
    for _ in range(MAX_TRIES):
        for m in M_LADDER:
            grid = build_grid(pxyz, pvalid, cell)
            dists, idx, nvalid, overflow, insufficient = grid_knn(
                grid, qxyz, qvalid, k, m
            )
            flags = np.asarray(jnp.stack([overflow, insufficient]))
            if not flags.any():
                return dists, idx, nvalid
            if not flags[0]:  # no overflow, just too small a cell
                break
        cell *= 1.6
    return bruteforce_knn(pxyz, pvalid, qxyz, qvalid, k)


def radius_count(pxyz, pvalid, qxyz, qvalid, radius: float):
    """Exact count of points within ``radius`` (inclusive) of each query."""
    n = pxyz.shape[0]
    if radius <= 0 or not np.isfinite(radius):
        return jnp.zeros((qxyz.shape[0],), jnp.int32)
    if n <= BRUTE_THRESHOLD:
        return bruteforce_radius_count(pxyz, pvalid, qxyz, qvalid, radius)
    ext = _extent(pxyz, pvalid)
    max_abs = ext[2] if ext else 0.0
    cell = _fp_safe_radius_cell(radius, max_abs)
    if n >= CELLGRID_MAX_N:
        for attempt in range(MAX_TRIES):
            m = M_LADDER[min(attempt, len(M_LADDER) - 1)]
            grid = build_grid(pxyz, pvalid, cell)
            counts, overflow = grid_radius_count(grid, qxyz, qvalid, radius, m)
            if not bool(overflow):
                return counts
        return bruteforce_radius_count(pxyz, pvalid, qxyz, qvalid, radius)
    cap = _cell_cap(n)
    for attempt in range(MAX_TRIES):
        m = M_LADDER[min(attempt, len(M_LADDER) - 1)]
        grid = build_cellgrid(
            pxyz, pvalid, cell, m_per_cell=m, cell_cap=cap
        )
        if bool(grid.table_overflow):
            break
        if not bool(grid.overflow):
            return point_radius_count(grid, qxyz, qvalid, radius)
    return bruteforce_radius_count(pxyz, pvalid, qxyz, qvalid, radius)


# Window-row budget of the 4-channel sweeps: each block materializes
# static [wr, ...] windows, so the budget stays small; blocks whose needed
# span overflows it are flagged and rescued exactly.
SWEEP_WR = 4


@partial(jax.jit, static_argnames=("wr", "rows"))
def _cluster_labels_packed(xyz, valid, radius, *, wr: int, rows: int = None):
    """Returns i32[rows + 1]: [labels, exact flag] in ONE fetch. The
    label->order sort stays on the host. ``rows`` (static) trims the
    fetched labels to the caller's leading-compact valid count — padding
    rows are always their own singleton labels, so the tail carries no
    information."""
    from .sweep import sweep_cluster_labels

    labels, exact = sweep_cluster_labels(xyz, valid, radius, wr=wr)
    if rows is not None and rows < labels.shape[0]:
        labels = labels[:rows]
    return jnp.concatenate([labels, exact.astype(labels.dtype)[None]])


def _surviving_component_ranks(labels, min_size: int, max_size: int):
    """Per-row rank of the row's component among the SURVIVING components
    (size in [min_size, max_size] inclusive), or -1 for rows of dropped
    components. Scatter-free: two payload sorts + segmented scans.

    Rank order == ascending representative-row order restricted to the
    survivors, so the host epilogue's canonical (size desc, label asc)
    tiebreak is unchanged. Returns (comp i32[n], n_surviving i32)."""
    n = labels.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    sl, sidx = jax.lax.sort((labels, pos), num_keys=1, is_stable=True)
    first = jnp.concatenate([jnp.ones((1,), bool), sl[1:] != sl[:-1]])
    # Component size per sorted position: (last pos of segment) - (first
    # pos) + 1, via forward cummax of segment starts and a reversed
    # cummax of segment ends.
    start_b = jax.lax.cummax(jnp.where(first, pos, 0))
    is_end = jnp.concatenate([first[1:], jnp.ones((1,), bool)])
    end_b = jax.lax.cummin(
        jnp.where(is_end, pos, jnp.int32(2**31 - 1)), reverse=True
    )
    size_b = end_b - start_b + 1
    ok_b = jnp.logical_and(size_b >= min_size, size_b <= max_size)
    surv_first = jnp.logical_and(first, ok_b)
    srank_b = jnp.cumsum(surv_first.astype(jnp.int32)) - 1  # const/segment
    out_sorted = jnp.where(ok_b, srank_b, jnp.int32(-1))
    n_surv = srank_b[-1] + 1
    # Unsort: one payload sort back by original row index.
    _, comp = jax.lax.sort((sidx, out_sorted), num_keys=1, is_stable=True)
    return comp, n_surv


@partial(jax.jit, static_argnames=("wr", "rows", "size_filter"))
def _cluster_labels_packed_u16(xyz, valid, radius, *, wr: int,
                               rows: int = None,
                               size_filter: tuple | None = None):
    """_cluster_labels_packed with RANK-COMPRESSED u16 labels: component
    rank (index of the representative among all representatives, ascending
    row id) replaces the representative row id. Rank order == label order,
    so the epilogue's canonical (size desc, label asc) tiebreak is
    unchanged, and the fetch halves (u16 vs i32). Layout: [comp u16[rows], exact u16, fits u16];
    fits=0 (more than 65535 components) sends the caller to the i32 path.

    ``size_filter=(min_size, max_size)``: components outside the size
    band are dropped ON DEVICE (rank sentinel 65535); ranks then count
    only SURVIVORS, so u16 virtually always fits — without this, scenes
    whose singleton noise pushes the component count past 65535 (the
    dense aerial workload: 166K obstacle points, tens of thousands of
    singletons) forced a second full i32 propagation+fetch per call.
    """
    from .sweep import sweep_cluster_labels

    labels, exact = sweep_cluster_labels(xyz, valid, radius, wr=wr)
    n = labels.shape[0]
    if size_filter is not None:
        comp, ncomp = _surviving_component_ranks(
            labels, int(size_filter[0]), int(size_filter[1])
        )
        sentinel = jnp.int32(65535)
        comp = jnp.where(comp < 0, sentinel, comp)
        fits = ncomp <= 65534  # 65535 reserved as the dropped sentinel
    else:
        is_rep = labels == jnp.arange(n, dtype=labels.dtype)
        rank = jnp.cumsum(is_rep.astype(jnp.int32)) - 1
        ncomp = rank[-1] + 1
        comp = jnp.take(rank, labels)
        fits = ncomp <= 65535
    if rows is not None and rows < comp.shape[0]:
        comp = comp[:rows]
    return jnp.concatenate(
        [
            comp.astype(jnp.uint16),
            exact.astype(jnp.uint16)[None],
            fits.astype(jnp.uint16)[None],
        ]
    )


def cluster_labels(xyz, valid, radius: float, n_valid: int = None,
                   size_filter: tuple | None = None):
    """Connected-component labels under inclusive distance ``radius``
    (non-finite/invalid points keep their own row as a singleton label),
    or None if no backend can certify exactness (caller falls back).

    ``size_filter=(min_size, max_size)``: when given AND the sweep path
    serves the query, returns (labels, True) where dropped components'
    rows carry label -1 and surviving rows carry the component's
    surviving-rank (ascending representative order) — the caller must
    exclude label < 0 rows before grouping. Falls back to
    (raw_labels, False) on the non-sweep paths. Without size_filter the
    return is the raw label array (backward compatible).

    Primary backend: sweep min-label propagation (hook + pointer jumping,
    `sweep.sweep_cluster_labels`); the collapsed cell-graph path remains
    as the second attempt for window-overflow cases.

    Returns labels i32[rows] in ORIGINAL row order as a host array (rows
    >= n_valid when given, else the full padded N), or None. Label VALUES
    are component ids whose ascending order equals ascending
    smallest-member-row order (the sweep path returns compressed ranks,
    the fallback paths representative row ids — either satisfies the
    epilogue's canonical size-desc/label-asc tiebreak identically).
    ``n_valid`` (leading-compact valid count) trims the device fetch —
    tail padding rows are always singletons. Grouping and canonical
    ordering are the caller's epilogue (native.cluster_epilogue / numpy
    fallback)."""
    n = xyz.shape[0]
    rows = (
        None if n_valid is None
        else min(n, max(128, -(-int(n_valid) // 128) * 128))
    )
    if n < CELLGRID_MAX_N and n > BRUTE_THRESHOLD // 4:
        # Window-row ladder: each rung is a full sort + propagation + host
        # sync, and windows are static [wr, ...] slices, so small rungs
        # come first.
        for wr in (7, 14, 28):
            # One fetch: rank-compressed u16 labels + (exact, fits) flags
            # ride one packed vector; the rare >65535-component cloud
            # refetches through the i32 path. With size_filter, ranks count
            # SURVIVING components only (sentinel 65535 -> -1).
            packed = np.asarray(
                _cluster_labels_packed_u16(
                    xyz, valid, np.float32(radius), wr=wr, rows=rows,
                    size_filter=size_filter,
                )
            )
            if not bool(packed[-1]):  # component count overflows u16
                packed32 = np.asarray(
                    _cluster_labels_packed(
                        xyz, valid, np.float32(radius), wr=wr, rows=rows
                    )
                )
                labels, exact, filtered = (
                    packed32[:-1], bool(packed32[-1]), False
                )
            else:
                labels = packed[:-2].astype(np.int32)
                if size_filter is not None:
                    labels[labels == 65535] = -1
                exact = bool(packed[-2])
                filtered = size_filter is not None
            if exact:
                out = np.asarray(labels, np.int32)
                return (out, filtered) if size_filter is not None else out
    ext = _extent(xyz, valid)
    max_abs = ext[2] if ext else 0.0
    # cell = r/2 keeps the cell diagonal below r (same-cell points are all
    # mutually connected) with ring-2 adjacency; the fp-safety margin from
    # _fp_safe_radius_cell shrinks the cell instead of growing it here, so
    # apply the margin to the ring reach by slightly shrinking the cell.
    cell = radius * 0.5 * (1.0 - 1e-5) - max_abs * 3e-7
    if cell <= 0 or n >= CELLGRID_MAX_N:
        return None
    cap = _cell_cap(n)
    for attempt in range(MAX_TRIES):
        m = M_LADDER[min(attempt, len(M_LADDER) - 1)]
        grid = build_cellgrid(
            xyz, valid, cell, m_per_cell=m, cell_cap=cap, ring=2
        )
        if bool(grid.table_overflow):
            return None
        if bool(grid.overflow):
            continue
        adjacency = cell_graph_adjacency(grid, jnp.float32(radius))
        out = np.asarray(cell_graph_labels(grid, adjacency), np.int32)
        return (out, False) if size_filter is not None else out
    return None


def radius_indices(pxyz, pvalid, query, radius: float):
    """Original-order indices of valid points within ``radius`` (inclusive)
    of one query point, as a host int array (ascending — nonzero order).

    Single-query searches stream the whole cloud once on device
    (knn.radius_within_mask); only the [N] bool mask returns to host.
    """
    mask = np.asarray(
        radius_within_mask(
            pxyz, pvalid, jnp.asarray(query, jnp.float32), np.float32(radius)
        )
    )
    return np.nonzero(mask)[0]


def radius_neighbors(xyz, valid, radius: float):
    """Exact capped neighbor lists of each point within ``radius``
    (inclusive), for the label-propagation fallback. Returns
    (idx i32[N,C], within bool[N,C]), or None if no cap in the ladder can
    hold every true neighbor — truncated lists would silently break the
    exactness contract, so the caller must route to the uncapped
    brute-force path instead (ops/segmentation.bruteforce_cluster_labels).
    """
    ext = _extent(xyz, valid)
    max_abs = ext[2] if ext else 0.0
    cell = _fp_safe_radius_cell(radius, max_abs)
    grid = build_grid(xyz, valid, cell)
    for m in (*M_LADDER, M_LADDER[-1] * 2, M_LADDER[-1] * 4):
        idx, within, overflow = grid_radius_neighbors(
            grid, xyz, valid, radius, m
        )
        if not bool(overflow):
            return idx, within
    return None


# ── Sweep-backed whole-cloud ops (exact-or-brute-rescued) ────────────────────
#
# The sorted-window sweep resolves the overwhelming majority of queries in
# one fused device pass; the residual flagged rows (sparse-region points,
# window overflows) are re-resolved EXACTLY by the tiled brute-force path
# on a compacted subset. One boolean-mask transfer per call.

_RESCUE_BUCKETS = (1024, 4096, 16384, 65536, 262144)


def _rescue_cap(count: int, n: int) -> int:
    for b in _RESCUE_BUCKETS:
        if count <= b:
            return min(b, n)
    return n


def sor_means(xyz, valid, k: int):
    """Exact mean distance to the k nearest non-self neighbors per point
    (+inf for isolated/invalid), KD-tree parity
    (ref: crates/filters/src/statistical_outlier.rs:19-39)."""
    from .sweep import sweep_sor_two_pass

    n = xyz.shape[0]
    if n <= BRUTE_THRESHOLD:
        return _brute_sor_means(xyz, valid, k)
    cell = estimate_cell_size(xyz, valid, k + 1)

    mean, point_ok, cert = sweep_sor_two_pass(
        xyz, valid, np.float32(cell), k=k, wr=SWEEP_WR
    )
    if bool(cert):
        return mean
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    residual = np.asarray(jnp.logical_and(valid & finite, ~point_ok))
    rows = np.nonzero(residual)[0]
    cap = _rescue_cap(len(rows), n)
    if len(rows) > cap:  # enormous residual: full brute instead
        return _brute_sor_means(xyz, valid, k)
    # Padding slots point at the out-of-bounds drop index: a zero-padded
    # index array would scatter STALE values back over row 0.
    sub = np.full((cap,), n, np.int32)
    sub[: len(rows)] = rows
    sub_valid = np.zeros((cap,), bool)
    sub_valid[: len(rows)] = True
    sub_means = _brute_sor_means_subset(
        xyz, valid, jnp.asarray(np.minimum(sub, n - 1)),
        jnp.asarray(sub_valid), k
    )
    return jnp.asarray(mean).at[jnp.asarray(sub)].set(
        sub_means, mode="drop"
    )


@partial(jax.jit, static_argnames=("k",))
def _brute_sor_means(xyz, valid, k: int):
    from ..ops.filters import sor_mean_dists_from_knn

    dists, _, nvalid = bruteforce_knn(xyz, valid, xyz, valid, k + 1)
    q_finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    return sor_mean_dists_from_knn(dists, nvalid, q_finite)


@partial(jax.jit, static_argnames=("k",))
def _brute_sor_means_subset(xyz, valid, sub_rows, sub_valid, k: int):
    from ..ops.filters import sor_mean_dists_from_knn

    qxyz = jnp.take(xyz, sub_rows, axis=0)
    dists, _, nvalid = bruteforce_knn(xyz, valid, qxyz, sub_valid, k + 1)
    q_finite = jnp.all(jnp.isfinite(qxyz), axis=-1)
    return sor_mean_dists_from_knn(dists, nvalid, q_finite)


def radius_count_sweep(pxyz, pvalid, radius: float):
    """Exact within-radius counts (self included) for every point of one
    cloud against itself — the radius-outlier-removal query
    (ref: crates/filters/src/radius_outlier.rs). Sweep + brute rescue."""
    from .sweep import sweep_radius_count

    n = pxyz.shape[0]
    if radius <= 0 or not np.isfinite(radius) or n <= BRUTE_THRESHOLD:
        return bruteforce_radius_count(pxyz, pvalid, pxyz, pvalid, radius)
    counts, point_ok = sweep_radius_count(
        pxyz, pvalid, np.float32(radius), wr=SWEEP_WR
    )
    finite = jnp.all(jnp.isfinite(pxyz), axis=-1)
    residual = np.asarray(jnp.logical_and(pvalid & finite, ~point_ok))
    if not residual.any():
        return counts
    rows = np.nonzero(residual)[0]
    cap = _rescue_cap(len(rows), n)
    if len(rows) > cap:
        return bruteforce_radius_count(pxyz, pvalid, pxyz, pvalid, radius)
    sub = np.full((cap,), n, np.int32)  # padding -> drop index (see sor_means)
    sub[: len(rows)] = rows
    sub_valid = np.zeros((cap,), bool)
    sub_valid[: len(rows)] = True
    sub_counts = bruteforce_radius_count(
        pxyz,
        pvalid,
        jnp.take(pxyz, jnp.asarray(np.minimum(sub, n - 1)), axis=0),
        jnp.asarray(sub_valid),
        radius,
    ).astype(jnp.int32)
    return jnp.asarray(counts).at[jnp.asarray(sub)].set(
        sub_counts, mode="drop"
    )


def normals(xyz, valid, k: int, viewpoint):
    """Exact PCA normals (k nearest incl. self, smallest eigenvector,
    viewpoint-oriented; ref: crates/normals/src/estimate.rs:42-107).
    Sweep KNN-moments + per-row exact rescue through the KNN engine."""
    from ..ops.normals import normals_from_knn
    from .sweep import sweep_knn_moments

    n = xyz.shape[0]
    vp = jnp.asarray(viewpoint, jnp.float32)
    if n <= BRUTE_THRESHOLD or k >= n:
        dists, idx, nvalid = knn(xyz, valid, xyz, valid, min(k, max(n, 1)))
        return normals_from_knn(xyz, idx, nvalid, vp)
    cell = estimate_cell_size(xyz, valid, k)

    m1, m2, cnt, point_ok = sweep_knn_moments(
        xyz, valid, np.float32(cell), k=k, wr=SWEEP_WR
    )
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    residual = np.asarray(jnp.logical_and(valid & finite, ~point_ok))
    nrm = _normals_from_moments(xyz, m1, m2, cnt, vp)
    if not residual.any():
        return nrm
    rows = np.nonzero(residual)[0]
    cap = _rescue_cap(len(rows), n)
    if len(rows) > cap:
        dists, idx, nvalid = knn(xyz, valid, xyz, valid, k)
        return normals_from_knn(xyz, idx, nvalid, vp)
    sub = np.full((cap,), n, np.int32)  # padding -> drop index (see sor_means)
    sub[: len(rows)] = rows
    sub_valid = np.zeros((cap,), bool)
    sub_valid[: len(rows)] = True
    # Single-dispatch exact rescue: tiled brute force (the grid-ladder
    # engine.knn would cost 10+ host round-trips on the subset).
    sub_n = _normals_rescue(
        xyz, valid, jnp.asarray(np.minimum(sub, n - 1)),
        jnp.asarray(sub_valid), vp, k
    )
    return jnp.asarray(nrm).at[jnp.asarray(sub)].set(sub_n, mode="drop")


@partial(jax.jit, static_argnames=("k",))
def _normals_rescue(xyz, valid, sub_rows, sub_valid, vp, k: int):
    from ..ops.normals import normals_from_knn

    sub_xyz = jnp.take(xyz, sub_rows, axis=0)
    dists, idx, nvalid = bruteforce_knn(xyz, valid, sub_xyz, sub_valid, k)
    return normals_from_knn(xyz, idx, nvalid, vp, query_xyz=sub_xyz)


@jax.jit
def _normals_from_moments(xyz, m1, m2, cnt, viewpoint):
    """Column-layout ([N,3]/[N,6]) adapter over the shared
    component-planar implementation (ops/normals.py:
    normals_from_moment_rows) — the transposes are cheap relative to the
    [N,3,3] covariance this used to materialize."""
    from ..ops.normals import normals_from_moment_rows

    return normals_from_moment_rows(
        jnp.transpose(m1), jnp.transpose(m2), cnt, xyz, viewpoint
    )


def _knn_sweep_same_cloud(pxyz, pvalid, k: int):
    """All-points KNN via the single-dispatch fused sweep + in-graph exact
    brute rescue (ops/fusedops.knn_fused). Returns None when the flagged
    residual exceeds the static rescue cap (caller falls back to the
    grid/brute ladder)."""
    from ..ops.fusedops import fused_rescue_cap, knn_fused

    n = pxyz.shape[0]

    dists, idx, nvalid, exact = knn_fused(
        pxyz, pvalid, k=k, wr=SWEEP_WR, cap=fused_rescue_cap(n)
    )
    if not int(np.asarray(exact)):
        return None  # sweep was a bad fit for this cloud
    return dists, idx, nvalid


def _knn_sweep_cross(pxyz, pvalid, qxyz, qvalid, k: int):
    """Cross-cloud KNN via the single-dispatch fused sweep: the point
    cloud is sorted/windowed once and the query set is sorted into the
    same cell frame (`sweep.sweep_knn_cross_two_pass`), replacing the
    per-call grid rebuild.
    Residual uncertified queries get one exact brute patch; returns None
    when the sweep was a bad fit for this pair (large residual — caller
    falls back to the grid/brute ladder)."""
    from ..ops.fusedops import fused_rescue_cap
    from ..spatial.sweep import sweep_knn_cross_two_pass

    n = pxyz.shape[0]
    qn = qxyz.shape[0]
    cell = estimate_cell_size(pxyz, pvalid, k)

    dists, idx, nvalid, ok = sweep_knn_cross_two_pass(
        pxyz, pvalid, qxyz, qvalid, np.float32(cell), k=k, wr=SWEEP_WR,
        fix_cap=fused_rescue_cap(max(n, qn)),
    )
    ok = np.asarray(ok)
    finite_q = np.asarray(
        jnp.logical_and(qvalid, jnp.all(jnp.isfinite(qxyz), axis=-1))
    )
    flagged = np.logical_and(finite_q, np.logical_not(ok))
    n_flagged = int(flagged.sum())
    if n_flagged == 0:
        return dists, idx, nvalid
    if n_flagged > max(qn // 4, 4096):
        return None  # sweep was a bad fit for this pair

    # Exact brute patch of the residual (identical to knn()'s pass 3).
    rows = np.nonzero(flagged)[0]
    sub_cap = max(1024, 1 << int(np.ceil(np.log2(len(rows)))))
    rows_pad = np.zeros(sub_cap, np.int64)
    rows_pad[: len(rows)] = rows
    sub_valid = np.arange(sub_cap) < len(rows)
    sq = jnp.take(qxyz, jnp.asarray(rows_pad), axis=0)
    sv = jnp.logical_and(
        jnp.take(qvalid, jnp.asarray(rows_pad)), jnp.asarray(sub_valid)
    )
    d3, i3, v3 = bruteforce_knn(pxyz, pvalid, sq, sv, k)
    dists = dists.at[jnp.asarray(rows_pad)].set(
        jnp.where(sv[:, None], d3, jnp.take(dists, jnp.asarray(rows_pad), axis=0))
    )
    idx = idx.at[jnp.asarray(rows_pad)].set(
        jnp.where(sv[:, None], i3, jnp.take(idx, jnp.asarray(rows_pad), axis=0))
    )
    nvalid = nvalid.at[jnp.asarray(rows_pad)].set(
        jnp.where(sv[:, None], v3, jnp.take(nvalid, jnp.asarray(rows_pad), axis=0))
    )
    return dists, idx, nvalid
