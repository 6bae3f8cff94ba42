"""Segmentation: RANSAC plane fitting and Euclidean clustering.

JAX redesign of the reference segmentation crate:

- RANSAC (ref: crates/segmentation/src/ransac_plane.rs:36-191): instead of a
  sequential hypothesis loop, all iterations' 3-point samples are drawn
  up-front from a counter-based JAX PRNG and scored in one batched pass
  (distance evaluation is a [3]x[3,N] matmul per hypothesis chunk). The
  first-best-count argmax matches the reference's parallel reduce
  (`a.1 >= b.1` keeps the earlier maximum, ref :89-91). Bit-parity with
  Rust's StdRng sampling is impossible by construction; determinism is
  guaranteed under our own seed and parity is defined on outputs
  (SURVEY.md section 7, "RANSAC sampling parity").

- Euclidean clustering (ref: crates/segmentation/src/euclidean_cluster.rs):
  union-find does not vectorize, so connected components are found by
  iterative min-label propagation with pointer jumping over grid-hash
  neighbor lists (threshold inclusive, d <= r). Non-finite points are
  excluded from the grid and remain singleton components (ref :110-119).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from ..core.cloud import compaction_order

_SCORE_CHUNK = 64
# Reference adaptive-termination constant: ln(1 - 0.999)
# (ref: crates/segmentation/src/ransac_plane.rs:110-116).
_LN_OUTLIER = math.log(0.001)
# Reference dispatch: the sequential adaptive path runs unless
# n >= 10_000 AND iterations >= 16 (ref :80, `use_parallel`).
_PARALLEL_MIN_POINTS = 10_000
_PARALLEL_MIN_ITERS = 16
# Score every hypothesis in ONE fused matmul when the [N, iters] distance
# intermediate stays under ~1.5 GB f32 (beyond that, chunk sequentially).
_SCORE_ONE_SHOT_ELEMS = 384 * 1024 * 1024


def _sample_three_distinct(key, iterations: int, cnt):
    """[iterations, 3] distinct indices into [0, cnt), uniformly.

    Exact distinct sampling without rejection: draw from shrinking ranges and
    shift past already-chosen values (replaces the reference's retry loop,
    ref: crates/segmentation/src/ransac_plane.rs:141-166).
    """
    cnt = jnp.maximum(cnt, 3)
    # ONE counter-based draw: key splits + per-range randint calls each
    # lower a separate threefry program; `bits` + modulo is one threefry
    # pass. Modulo bias is
    # < 2^-15 at practical cloud sizes — RANSAC sampling is not an
    # exactness surface (SURVEY.md §7: parity is defined on outputs).
    # Cross-backend determinism is preserved (threefry bits are
    # backend-identical; the mod is integer math).
    bits = jax.random.bits(key, (3, iterations))
    cu = cnt.astype(jnp.uint32)
    a = (bits[0] % cu).astype(jnp.int32)
    b = (bits[1] % (cu - 1)).astype(jnp.int32)
    b = b + (b >= a)
    lo = jnp.minimum(a, b)
    hi = jnp.maximum(a, b)
    c = (bits[2] % (cu - 2)).astype(jnp.int32)
    c = c + (c >= lo)
    c = c + (c >= hi)
    return jnp.stack([a, b, c], axis=1)


def _ransac_sequential_scan(xyz, use_pt, normal, d, degenerate, threshold,
                            cnt, iterations: int, chunk: int = 16):
    """Reference sequential-RANSAC semantics with adaptive early
    termination, evaluated chunk-at-a-time inside a ``lax.while_loop``.

    The reference walks hypotheses one by one, keeps the first running
    maximum (strict ``>`` improvements), and — only at an improving
    iteration — breaks when ``iter > ln(0.001)/ln(1-w^3)`` with
    ``w = best_count/n`` and ``w > 0.5``
    (ref: crates/segmentation/src/ransac_plane.rs:93-121). Here each
    while-loop step scores ``chunk`` hypotheses in one masked matmul and
    replays that exact sequential rule inside the chunk with a running
    max, so the selected winner and the evaluated-iteration count match
    the reference's loop (at chunk-granularity evaluation COST, not
    chunk-granularity SEMANTICS).

    Returns ``(best_iter i32, best_count i32, n_evaluated i32)``.
    """
    C = max(1, min(chunk, iterations))
    nch = -(-iterations // C)
    pad = nch * C - iterations
    if pad:
        normal = jnp.concatenate([normal, jnp.zeros((pad, 3), normal.dtype)])
        d = jnp.concatenate([d, jnp.zeros((pad,), d.dtype)])
        degenerate = jnp.concatenate(
            [degenerate, jnp.ones((pad,), degenerate.dtype)]
        )
    iota = jnp.arange(C, dtype=jnp.int32)
    n64 = jnp.maximum(cnt.astype(jnp.float64), 1.0)
    neg_inf32 = jnp.int32(-(2**31) + 1)

    def cond(carry):
        ci, _bc, _bi, _ne, stop = carry
        return jnp.logical_and(ci < nch, jnp.logical_not(stop))

    def body(carry):
        ci, bc, bi, ne, _stop = carry
        base = ci * C
        nc = jax.lax.dynamic_slice(normal, (base, jnp.int32(0)), (C, 3))
        dc = jax.lax.dynamic_slice(d, (base,), (C,))
        degc = jax.lax.dynamic_slice(degenerate, (base,), (C,))
        dist = jnp.abs(
            jax.lax.dot(xyz, nc.T, precision=jax.lax.Precision.HIGHEST)
            + dc[None, :]
        )
        ok = jnp.logical_and(use_pt[:, None], dist <= threshold)
        c = jnp.sum(ok, axis=0, dtype=jnp.int32)  # dtype pinned: x64
        # promotes plain int32 sums to int64, breaking the carry types
        c = jnp.where(degc, jnp.int32(-1), c)
        g = base + iota
        # Exclusive running max before each in-chunk position.
        cm = jax.lax.cummax(c, axis=0)
        pre = jnp.maximum(
            bc, jnp.concatenate([neg_inf32[None], cm[:-1]])
        )
        improved = c > pre
        w = c.astype(jnp.float64) / n64
        # ln(1 - w^3) is negative for w in (0, 1); the clip only guards
        # w == 1 where the reference's -inf denominator gives needed = 0
        # (the comparison below is unchanged: iter 0 never satisfies
        # 0 > needed, and improvements past w = 1 are impossible).
        denom = jnp.log(jnp.clip(1.0 - w**3, 1e-300, None))
        needed = _LN_OUTLIER / denom
        brk = improved & (w > 0.5) & (g.astype(jnp.float64) > needed)
        fb = jnp.min(jnp.where(brk, iota, jnp.int32(C)))
        inc = iota <= fb  # the breaking iteration itself IS evaluated
        cmask = jnp.where(inc, c, neg_inf32)
        cmax = jnp.max(cmask)
        carg = jnp.argmax(cmask).astype(jnp.int32)  # first occurrence
        upd = cmax > bc
        bc2 = jnp.where(upd, cmax, bc)
        bi2 = jnp.where(upd, base + carg, bi)
        nvalid = jnp.minimum(jnp.int32(C), jnp.int32(iterations) - base)
        ne2 = ne + jnp.minimum(fb + 1, nvalid)
        return (ci + 1, bc2, bi2, ne2, fb < C)

    _, bc, bi, ne, _ = jax.lax.while_loop(
        cond,
        body,
        (jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0),
         jnp.asarray(False)),
    )
    return bi, bc, ne


@partial(jax.jit, static_argnames=("iterations", "assume_compact",
                                   "score_subsample", "rescore_top",
                                   "adaptive"))
def ransac_plane_masked(xyz, valid, threshold, seed, iterations: int,
                        *, assume_compact: bool = False,
                        score_subsample: int | None = None,
                        rescore_top: int = 8,
                        adaptive: bool = False,
                        position_rows=None):
    """Batched RANSAC plane fit on a masked cloud.

    Returns (normal f32[3], d f32, inlier_mask bool[N]). With fewer than 3
    valid points the default model (normal (0,0,1), d=0) and an empty inlier
    set are returned (ref: crates/segmentation/src/ransac_plane.rs:62-66).

    ``assume_compact=True`` asserts the valid rows are exactly the leading
    ``sum(valid)`` rows (true for voxel-downsample outputs), so sample
    positions are row indices directly and the compaction sort is skipped.

    ``score_subsample=m`` scores every hypothesis on m evenly-spaced
    valid points, then rescores only the ``rescore_top`` leaders over the
    FULL cloud and takes the first maximum — the final model and its
    inliers are always full-cloud counts (the reference itself recomputes
    final inliers over all points, ref :124-128), only which hypothesis
    WINS is decided via the tournament. With m >= 4096 the subsample
    inlier-fraction error is < ~1%, far below the winner's margin on real
    ground planes, so the chosen plane matches full scoring in practice;
    the scoring cost drops from O(iters * N) to O(iters * m + top * N).

    ``adaptive=True`` reproduces the reference's DISPATCH between its two
    scoring paths (ref :80): clouds with >= 10_000 valid points and >= 16
    iterations score every hypothesis (the parallel reduce — this
    function's default batched path), smaller problems run the sequential
    loop with adaptive early termination (``_ransac_sequential_scan``,
    ref :93-121) which stops at the first improving hypothesis whose
    index exceeds ln(0.001)/ln(1-w^3). Ignored under tournament scoring
    (a superset knob with no reference counterpart). Off by default so
    direct callers get pure full scoring.
    """
    n = xyz.shape[0]
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    cnt = jnp.sum(valid.astype(jnp.int32))

    key = jax.random.PRNGKey(seed)
    samples = _sample_three_distinct(key, iterations, cnt)  # positions
    order = None
    if position_rows is not None:
        # Caller-provided position -> row map (e.g. the fused pipeline's
        # canonical-order mini-sort): hypothesis selection stays identical
        # to the compacted per-op path without a full compaction sort here.
        order = position_rows.astype(jnp.int32)
        idx = jnp.take(order, samples.reshape(-1)).reshape(samples.shape)
    elif assume_compact:
        idx = samples  # position p IS original row p
    else:
        # Compacted index map: position p (< cnt) -> original row.
        order = compaction_order(valid)
        idx = jnp.take(order, samples.reshape(-1)).reshape(samples.shape)
    # Flat 1-D index vector rather than an [I, 3] 2-D index gather.
    p = jnp.take(xyz, idx.reshape(-1), axis=0).reshape(
        idx.shape[0], 3, 3
    )  # [I, 3, 3]

    v1 = p[:, 1] - p[:, 0]
    v2 = p[:, 2] - p[:, 0]
    nrm = jnp.cross(v1, v2)
    length = jnp.linalg.norm(nrm, axis=1)
    degenerate = length < 1e-10  # collinear / coincident (ref :183-186)
    safe_len = jnp.where(degenerate, 1.0, length)
    normal = nrm / safe_len[:, None]
    d = -jnp.sum(normal * p[:, 0], axis=1)  # [I]

    use_pt = jnp.logical_and(valid, finite)

    def score_chunk(args):
        nc, dc = args  # [C, 3], [C]
        # (HIGHEST: a reduced-precision f32 matmul (bf16 or TF32) costs
        # ~1e-2 m at 10-m coordinates — larger than typical RANSAC
        # thresholds)
        dist = jnp.abs(
            jax.lax.dot(xyz, nc.T, precision=jax.lax.Precision.HIGHEST)
            + dc[None, :]
        )  # [N, C]
        ok = jnp.logical_and(use_pt[:, None], dist <= threshold)
        return jnp.sum(ok.astype(jnp.int32), axis=0)

    if score_subsample is not None and iterations > rescore_top:
        # ── Tournament scoring ──
        m = score_subsample
        # floor(i * cnt / m) without int32 overflow (i * cnt can exceed
        # 2^31 at 16M points): i*(cnt//m) + i*(cnt%m)//m, i*(cnt%m) < 2^28.
        ar = jnp.arange(m, dtype=jnp.int32)
        pos = ar * (cnt // m) + (ar * (cnt % m)) // m
        # Duplicate positions appear when cnt < m; mask them so subsample
        # counts stay counts over distinct points.
        distinct = jnp.concatenate(
            [jnp.ones((1,), bool), pos[1:] != pos[:-1]]
        )
        sub_rows = pos if order is None else jnp.take(order, pos)
        sub_xyz = jnp.take(xyz, sub_rows, axis=0)
        sub_use = jnp.logical_and(jnp.take(use_pt, sub_rows), distinct)
        sdist = jnp.abs(
            jax.lax.dot(sub_xyz, normal.T,
                        precision=jax.lax.Precision.HIGHEST)
            + d[None, :]
        )  # [m, I]
        sub_counts = jnp.sum(
            jnp.logical_and(sub_use[:, None], sdist <= threshold)
            .astype(jnp.int32),
            axis=0,
        )
        sub_counts = jnp.where(degenerate, -1, sub_counts)
        # Leaders, ties broken toward the EARLIER hypothesis (the
        # reference's first-max reduce): key = count * I + (I-1-index).
        ii = jnp.arange(iterations, dtype=jnp.int32)
        _, top_idx = jax.lax.top_k(
            sub_counts * iterations + (iterations - 1 - ii), rescore_top
        )
        full_counts = score_chunk(
            (jnp.take(normal, top_idx, axis=0), jnp.take(d, top_idx))
        )
        full_counts = jnp.where(
            jnp.take(degenerate, top_idx), -1, full_counts
        )
        mx = jnp.max(full_counts)
        best = jnp.min(jnp.where(full_counts == mx, top_idx, iterations))
        best_count = mx
    else:
        def _full_best(_):
            counts = _score_all()
            counts = jnp.where(degenerate, -1, counts)
            b = jnp.argmax(counts).astype(jnp.int32)
            return b, counts[b].astype(jnp.int32)

        def _score_all():
            if iterations * n <= _SCORE_ONE_SHOT_ELEMS:
                # One batched matmul for every hypothesis: the
                # sequential lax.map chunking costs several serialized
                # [N, C] passes; at demo scale (300 iters x 241K pts -> a
                # 290 MB f32 intermediate) a single fused dot + mask +
                # reduce is one streamed pass.
                return score_chunk((normal, d))
            pad = (-iterations) % _SCORE_CHUNK
            normal_p = jnp.concatenate(
                [normal, jnp.zeros((pad, 3), normal.dtype)]
            )
            d_p = jnp.concatenate([d, jnp.zeros((pad,), d.dtype)])
            nchunks = normal_p.shape[0] // _SCORE_CHUNK
            return jax.lax.map(
                score_chunk,
                (
                    normal_p.reshape(nchunks, _SCORE_CHUNK, 3),
                    d_p.reshape(nchunks, _SCORE_CHUNK),
                ),
            ).reshape(-1)[:iterations]

        if adaptive and iterations >= 2:
            # Reference dispatch (ref :80): the sequential
            # adaptive-early-termination path runs unless
            # n >= 10_000 AND iterations >= 16. ``n`` there is the
            # runtime point count, so the branch is a lax.cond (under
            # vmap both branches execute and select; the standalone
            # pipelines are unbatched, so only one branch runs).
            def _seq_best(_):
                bi, bc, _ne = _ransac_sequential_scan(
                    xyz, use_pt, normal, d, degenerate, threshold, cnt,
                    iterations,
                )
                return bi, bc

            if iterations < _PARALLEL_MIN_ITERS:
                best, best_count = _seq_best(None)
            else:
                best, best_count = jax.lax.cond(
                    cnt >= _PARALLEL_MIN_POINTS, _full_best, _seq_best, None
                )
        else:
            # first maximum, like the reference's parallel reduce
            best, best_count = _full_best(None)

    found = best_count > 0
    enough = cnt >= 3
    ok_model = jnp.logical_and(found, enough)
    best_normal = jnp.where(ok_model, normal[best], jnp.array([0.0, 0.0, 1.0]))
    best_d = jnp.where(ok_model, d[best], 0.0)

    # Final inliers recomputed over the full cloud (ref :124-128). The
    # reference indexes raw point data (finite check is implicit: NaN
    # distances fail <=). Elementwise, NOT a [N, 1] matmul with a 1-wide
    # output column.
    dist = jnp.abs(
        xyz[:, 0] * best_normal[0]
        + xyz[:, 1] * best_normal[1]
        + xyz[:, 2] * best_normal[2]
        + best_d
    )
    inlier_mask = jnp.logical_and(valid, dist <= threshold)
    inlier_mask = jnp.logical_and(inlier_mask, enough)
    return best_normal, best_d, inlier_mask


@partial(jax.jit, static_argnames=("iterations", "assume_compact",
                                   "score_subsample", "adaptive"))
def ransac_plane_bytes(xyz, valid, threshold, seed, iterations: int,
                       *, assume_compact: bool = False,
                       score_subsample: int | None = None,
                       adaptive: bool = False):
    """ransac_plane_masked with EVERYTHING in one uint8[16 + N/8] buffer:
    bytes [0:16] are the little-endian f32 scalars [nx, ny, nz, d]
    (bitcast, exact) and bytes [16:] the inlier mask BIT-PACKED
    little-bit-order (np.unpackbits(..., bitorder="little") on the host).
    ONE device->host fetch serves the whole PlaneResult, and packing cuts
    the mask payload 8x."""
    n = xyz.shape[0]
    assert n % 8 == 0, n  # capacities are multiples of 128
    normal, d, inlier_mask = ransac_plane_masked(
        xyz, valid, threshold, seed, iterations,
        assume_compact=assume_compact, score_subsample=score_subsample,
        adaptive=adaptive,
    )
    scal = jax.lax.bitcast_convert_type(
        jnp.concatenate([normal, d[None]]).astype(jnp.float32), jnp.uint8
    ).reshape(16)
    bits = inlier_mask.astype(jnp.uint8).reshape(-1, 8)
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)
    packed = jnp.sum(bits * weights[None, :], axis=1, dtype=jnp.uint8)
    return jnp.concatenate([scal, packed])


# ── Euclidean clustering ─────────────────────────────────────────────────────


@jax.jit
def propagate_labels(neighbor_idx, within, valid):
    """Connected components by min-label propagation + pointer jumping.

    ``neighbor_idx``/``within`` are capped per-point neighbor lists from the
    grid engine (distance <= r, inclusive). Returns int32 labels where
    label[i] == label[j] iff i and j are in the same component; isolated and
    invalid points keep their own index.
    """
    n = neighbor_idx.shape[0]
    init = jnp.arange(n, dtype=jnp.int32)

    def body(state):
        labels, _ = state
        nl = jnp.take(labels, neighbor_idx, axis=0)  # [N, C]
        nl = jnp.where(within, nl, n)
        m = jnp.minimum(jnp.min(nl, axis=1), labels)
        # Pointer jumping keeps convergence logarithmic in chain length
        # (SURVEY.md section 7 hard part 2).
        m = jnp.minimum(m, jnp.take(m, m))
        m = jnp.minimum(m, jnp.take(m, m))
        changed = jnp.any(m != labels)
        return m, changed

    labels, _ = jax.lax.while_loop(
        lambda s: s[1], body, (init, jnp.asarray(True))
    )
    del valid  # validity is already encoded in `within`
    return labels


_BF_CHUNK = 512


@jax.jit
def bruteforce_cluster_labels(xyz, valid, radius):
    """Exact connected-component labels by tiled all-pairs min-label
    propagation: the uncapped last resort for pathological densities where
    no per-cell candidate cap can hold every true neighbor (the grid paths
    would otherwise have to silently truncate). O(n^2) distances per sweep;
    pointer jumping keeps the sweep count logarithmic.
    """
    n = xyz.shape[0]
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    use = jnp.logical_and(valid, finite)
    r2 = radius * radius
    big = jnp.int32(n)

    pad = (-n) % _BF_CHUNK
    xyz_p = jnp.concatenate([xyz, jnp.zeros((pad, 3), xyz.dtype)])
    use_p = jnp.concatenate([use, jnp.zeros((pad,), bool)])
    nch = xyz_p.shape[0] // _BF_CHUNK

    def body(state):
        labels, _ = state

        def chunk_fn(args):
            qx, qu = args
            diff = qx[:, None, :] - xyz[None, :, :]
            d2 = jnp.sum(diff * diff, axis=-1)
            within = jnp.logical_and(
                jnp.logical_and(qu[:, None], use[None, :]), d2 <= r2
            )
            return jnp.min(jnp.where(within, labels[None, :], big), axis=1)

        mins = jax.lax.map(
            chunk_fn,
            (
                xyz_p.reshape(nch, _BF_CHUNK, 3),
                use_p.reshape(nch, _BF_CHUNK),
            ),
        ).reshape(-1)[:n]
        m = jnp.minimum(labels, mins)
        m = jnp.minimum(m, jnp.take(m, m))
        m = jnp.minimum(m, jnp.take(m, m))
        return m, jnp.any(m != labels)

    init = jnp.arange(n, dtype=jnp.int32)
    labels, _ = jax.lax.while_loop(
        lambda s: s[1], body, (init, jnp.asarray(True))
    )
    return labels
