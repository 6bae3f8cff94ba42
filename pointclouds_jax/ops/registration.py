"""Rigid registration: point-to-point and point-to-plane ICP.

JAX redesign of the reference registration crate
(ref: crates/registration/src/icp.rs, icp_plane.rs): the sequential outer
loop becomes a jitted ``lax.while_loop`` whose body does a fully batched
nearest-neighbor pass (tiled brute-force matmul over the N_src x N_tgt
distance block — exact),
masked-weighted RMSE/fitness, and a closed 3x3 SVD (p2p, ref icp.rs:210-270)
or regularized 6x6 normal-equation solve (p2plane, ref icp_plane.rs:131-236).

Loop semantics mirror the reference exactly: convergence is checked on
|prev_rmse - rmse| < tolerance BEFORE solving (ref icp.rs:173-177), the
converging iteration still counts, an empty correspondence set breaks without
updating the last metrics, and the cumulative transform composes as
R_new = R_inc @ R_cum, t_new = R_inc @ t_cum + t_inc (ref icp.rs:52-73).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_NN_CHUNK = 4096
# One-shot correspondence search below this [Q, N] element budget (the
# sequential lax.map chunking serializes small matmuls per ICP iteration;
# a single fused dot + argmin is one streamed pass). 512M elements = 2 GB
# f32 transient — covers two 16384-bucket clouds (the reference's 10K ICP
# row) in one shot.
_NN_ONE_SHOT_ELEMS = 512 * 1024 * 1024


class IcpCarry(NamedTuple):
    current: jax.Array  # f32[N, 3] transformed source
    rot: jax.Array  # f32[3, 3] cumulative rotation
    trans: jax.Array  # f32[3] cumulative translation
    prev_rmse: jax.Array
    last_rmse: jax.Array
    last_fitness: jax.Array
    iterations: jax.Array  # i32
    converged: jax.Array  # bool
    stop: jax.Array  # bool


def _nn_1(qxyz, q_use, pxyz, p_use):
    """Tiled exact 1-NN: returns (dist f32[Q], idx i32[Q], found bool[Q]).

    Coordinates are centered on the target AABB midpoint before
    the matmul-form distance: the |q|^2+|p|^2-2qp expansion carries an
    absolute f32 error ~eps*|q|^2 that at georeferenced (UTM-scale)
    offsets dwarfs real correspondence distances and makes the argmin pick
    arbitrary points. Distances are translation-invariant, so centering
    makes the error scale with the scene SPAN instead of its offset.
    """
    plo = jnp.min(jnp.where(p_use[:, None], pxyz, jnp.inf), axis=0)
    phi = jnp.max(jnp.where(p_use[:, None], pxyz, -jnp.inf), axis=0)
    center = jnp.where(jnp.isfinite(plo), 0.5 * plo + 0.5 * phi, 0.0)
    pc = jnp.where(p_use[:, None], pxyz - center, 0.0)
    p2 = jnp.sum(pc * pc, axis=-1)
    pmask = jnp.where(p_use, 0.0, jnp.inf)

    qn = qxyz.shape[0]
    pad = (-qn) % _NN_CHUNK
    qpad = jnp.concatenate([qxyz, jnp.zeros((pad, 3), qxyz.dtype)])
    nchunks = qpad.shape[0] // _NN_CHUNK

    def chunk_fn(qc):
        qcc = jnp.where(jnp.all(jnp.isfinite(qc), axis=-1)[:, None], qc - center, 0.0)
        d2 = (
            jnp.sum(qcc * qcc, axis=-1)[:, None]
            + p2[None, :]
            - 2.0 * jax.lax.dot(qcc, pc.T, precision=jax.lax.Precision.HIGHEST)
        )
        d2 = d2 + pmask[None, :]
        # Tie-break toward the last index: exact distance ties occur in
        # symmetric scenes (e.g. a lattice at exactly half-shift), where
        # first-index ties systematically pull backwards and stall ICP.
        npts = d2.shape[1]
        rev = jnp.argmin(d2[:, ::-1], axis=1)
        idx = npts - 1 - rev
        best = jnp.take_along_axis(d2, idx[:, None], axis=1)[:, 0]
        # The matmul form loses precision for small distances; recompute the
        # chosen pair's distance exactly (parity: kiddo reports exact f32
        # squared euclidean).
        chosen = jnp.take(pxyz, idx, axis=0)
        diff = chosen - qc
        best = jnp.where(
            jnp.isfinite(best), jnp.sum(diff * diff, axis=-1), best
        )
        return best, idx.astype(jnp.int32)

    if qpad.shape[0] * pxyz.shape[0] <= _NN_ONE_SHOT_ELEMS:
        d2, idx = chunk_fn(qpad)
        d2 = d2[:qn]
        idx = idx[:qn]
    else:
        d2s, idxs = jax.lax.map(
            chunk_fn, qpad.reshape(nchunks, _NN_CHUNK, 3)
        )
        d2 = d2s.reshape(-1)[:qn]
        idx = idxs.reshape(-1)[:qn]
    found = jnp.logical_and(q_use, jnp.isfinite(d2))
    dist = jnp.sqrt(jnp.maximum(d2, 0.0))
    return dist, idx, found


def _quat_from_cross_covariance(h):
    """Optimal rotation quaternion from a 3x3 cross-covariance (Horn 1987).

    The reference solves this with nalgebra SVD + a det(V U^T) reflection fix
    (ref: crates/registration/src/icp.rs:245-261). Horn's quaternion method
    is pure arithmetic (a 4x4 symmetric eigenproblem solved by shifted
    power iteration, no LAPACK-style custom calls inside the ICP
    while_loop) and it cannot produce a reflection, so the det fix is
    unnecessary by construction.
    """
    n = jnp.array(
        [
            [
                h[0, 0] + h[1, 1] + h[2, 2],
                h[1, 2] - h[2, 1],
                h[2, 0] - h[0, 2],
                h[0, 1] - h[1, 0],
            ],
            [
                h[1, 2] - h[2, 1],
                h[0, 0] - h[1, 1] - h[2, 2],
                h[0, 1] + h[1, 0],
                h[0, 2] + h[2, 0],
            ],
            [
                h[2, 0] - h[0, 2],
                h[0, 1] + h[1, 0],
                -h[0, 0] + h[1, 1] - h[2, 2],
                h[1, 2] + h[2, 1],
            ],
            [
                h[0, 1] - h[1, 0],
                h[0, 2] + h[2, 0],
                h[1, 2] + h[2, 1],
                -h[0, 0] - h[1, 1] + h[2, 2],
            ],
        ]
    )
    # Shift so the largest eigenvalue of N dominates in magnitude.
    shift = jnp.sqrt(jnp.sum(n * n)) + 1e-12
    ns = n + shift * jnp.eye(4, dtype=n.dtype)

    # Power method via repeated matrix squaring: ns^(2^6) @ q0 equals 64
    # power steps but costs 6 tiny 4x4 matmuls instead of 64 serialized
    # matvec+normalize trips. Normalizing by the Frobenius norm between
    # squarings keeps entries in range; the whole 4x4 chain runs in f64
    # (squaring squares roundoff too — in f32 the recovered quaternion
    # jitters at ~1e-7 and tight-tolerance ICP never sees |delta rmse|
    # settle; the 4x4 f64 chain is ~100 flops).
    hi = jax.lax.Precision.HIGHEST
    for _ in range(6):
        ns = ns / jnp.maximum(jnp.sqrt(jnp.sum(ns * ns)), 1e-30)
        ns = jax.lax.dot(ns, ns, precision=hi)

    # The identity-biased start makes degenerate cases (H ~ 0) converge
    # toward the identity rotation.
    q0 = jnp.array([1.0, 1e-2, 1e-2, 1e-2], n.dtype)
    q0 = q0 / jnp.linalg.norm(q0)
    q = jax.lax.dot(ns, q0[:, None], precision=hi)[:, 0]
    return q / jnp.maximum(jnp.linalg.norm(q), 1e-30)


def _quat_to_rot(q):
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.array(
        [
            [
                1.0 - 2.0 * (y * y + z * z),
                2.0 * (x * y - w * z),
                2.0 * (x * z + w * y),
            ],
            [
                2.0 * (x * y + w * z),
                1.0 - 2.0 * (x * x + z * z),
                2.0 * (y * z - w * x),
            ],
            [
                2.0 * (x * z - w * y),
                2.0 * (y * z + w * x),
                1.0 - 2.0 * (x * x + y * y),
            ],
        ]
    )


def _svd_rigid_solve(src, tgt_pts, w):
    """Weighted optimal rigid transform aligning src -> tgt under weights w.

    Same objective as the reference's SVD Kabsch solve
    (ref: crates/registration/src/icp.rs:210-270); see
    `_quat_from_cross_covariance` for why the rotation is recovered via
    Horn's quaternion method instead of SVD.
    """
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    ws = w[:, None]
    src_c = jnp.sum(ws * src, axis=0) / wsum
    tgt_c = jnp.sum(ws * tgt_pts, axis=0) / wsum
    sc = src - src_c
    tc = tgt_pts - tgt_c
    # (HIGHEST: a reduced-precision f32 matmul would corrupt the
    # correlation sums)
    h = jax.lax.dot((ws * sc).T, tc, precision=jax.lax.Precision.HIGHEST)

    q = _quat_from_cross_covariance(h)
    # Snap sub-noise increments to the exact identity: a rotation with
    # |q_vec| < 1e-6 (angle < 2e-6 rad) displaces centered f32 points by
    # less than their own rounding, so applying it only injects noise —
    # and at ICP's fixed point that noise makes rmse wander forever at
    # ~1e-7 instead of repeating bit-exactly (the while_loop's
    # |delta rmse| < tolerance test then never fires for tight
    # tolerances). With the snap, the fixed point is a true fixed point.
    vmag2 = q[1] * q[1] + q[2] * q[2] + q[3] * q[3]
    q = jnp.where(vmag2 < 1e-12, jnp.array([1.0, 0.0, 0.0, 0.0], q.dtype), q)
    rot = _quat_to_rot(q)
    trans = tgt_c - jax.lax.dot(
        rot, src_c[:, None], precision=jax.lax.Precision.HIGHEST
    )[:, 0]
    # Same reasoning for translation: components under ~2 ulps of the
    # largest participating coordinate cannot displace f32 points, they
    # only keep the fixed point wandering. Snap them to exactly 0.
    scale = jnp.max(jnp.abs(ws * tgt_pts))
    trans = jnp.where(jnp.abs(trans) < 2.4e-7 * scale, 0.0, trans)
    return rot, trans


def _plane_solve(src, tgt_pts, tgt_nrm, w):
    """Linearized point-to-plane solve: 6x6 normal equations with Tikhonov
    damping, Rodrigues rotation recovery
    (ref: crates/registration/src/icp_plane.rs:131-236)."""
    a = jnp.concatenate([jnp.cross(src, tgt_nrm), tgt_nrm], axis=1)  # [N, 6]
    b = jnp.sum((tgt_pts - src) * tgt_nrm, axis=1)  # [N]
    ws = w[:, None]
    # The reference accumulates and solves in f64 (icp_plane.rs:145): in f32
    # the tangential components of the solution jitter at ~1e-3 scale, which
    # keeps |delta rmse| above the convergence tolerance forever. The big
    # N-point accumulation stays f32 (XLA's tree reduction keeps it
    # accurate); only the tiny 6x6 solve is promoted.
    ata = jax.lax.dot((ws * a).T, a, precision=jax.lax.Precision.HIGHEST).astype(jnp.float64)
    atb = jax.lax.dot((ws * a).T, b, precision=jax.lax.Precision.HIGHEST).astype(jnp.float64)

    diag_max = jnp.max(jnp.abs(jnp.diagonal(ata)))
    lam = 1e-6 * jnp.maximum(diag_max, 1e-12)
    ata = ata + lam * jnp.eye(6, dtype=ata.dtype)
    x = jnp.linalg.solve(ata, atb).astype(jnp.float32)

    alpha, beta, gamma = x[0], x[1], x[2]
    trans = x[3:6]
    angle = jnp.sqrt(alpha**2 + beta**2 + gamma**2)
    small = angle < 1e-10
    safe = jnp.where(small, 1.0, angle)
    ax, ay, az = alpha / safe, beta / safe, gamma / safe
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    t = 1.0 - c
    rod = jnp.array(
        [
            [t * ax * ax + c, t * ax * ay - s * az, t * ax * az + s * ay],
            [t * ax * ay + s * az, t * ay * ay + c, t * ay * az - s * ax],
            [t * ax * az - s * ay, t * ay * az + s * ax, t * az * az + c],
        ]
    )
    lin = jnp.array(
        [
            [1.0, -gamma, beta],
            [gamma, 1.0, -alpha],
            [-beta, alpha, 1.0],
        ]
    )
    rot = jnp.where(small, lin, rod)
    return rot, trans


def _icp_loop(
    src_xyz,
    src_valid,
    tgt_xyz,
    tgt_valid,
    tgt_normals,
    max_iterations: int,
    tolerance,
    max_dist,
    point_to_plane: bool,
):
    src_finite = jnp.all(jnp.isfinite(src_xyz), axis=-1)
    src_use = jnp.logical_and(src_valid, src_finite)
    tgt_finite = jnp.all(jnp.isfinite(tgt_xyz), axis=-1)
    tgt_use = jnp.logical_and(tgt_valid, tgt_finite)
    n_src = jnp.maximum(jnp.sum(src_valid.astype(jnp.float32)), 1.0)

    # Run the entire loop in a target-centered frame: at georeferenced
    # offsets (~1e5) the f32 centroid sums bias the cross-covariance enough
    # to tilt the recovered rotation by ~1e-5 rad, and t = t_c - R s_c then
    # amplifies that by the coordinate magnitude (meters of error).
    # Centering makes every accumulated quantity span-scale; the transform
    # is mapped back to the raw frame after the loop.
    tlo = jnp.min(jnp.where(tgt_use[:, None], tgt_xyz, jnp.inf), axis=0)
    thi = jnp.max(jnp.where(tgt_use[:, None], tgt_xyz, -jnp.inf), axis=0)
    center = jnp.where(jnp.isfinite(tlo), 0.5 * tlo + 0.5 * thi, 0.0)
    src_xyz = src_xyz - center
    tgt_xyz = tgt_xyz - center

    init = IcpCarry(
        current=src_xyz,
        rot=jnp.eye(3, dtype=jnp.float32),
        trans=jnp.zeros(3, jnp.float32),
        prev_rmse=jnp.asarray(jnp.inf, jnp.float32),
        last_rmse=jnp.asarray(jnp.inf, jnp.float32),
        last_fitness=jnp.asarray(0.0, jnp.float32),
        iterations=jnp.asarray(0, jnp.int32),
        converged=jnp.asarray(False),
        stop=jnp.asarray(False),
    )

    def cond(c: IcpCarry):
        return jnp.logical_and(c.iterations < max_iterations, ~c.stop)

    def body(c: IcpCarry):
        dist, idx, found = _nn_1(c.current, src_use, tgt_xyz, tgt_use)
        w = jnp.logical_and(found, dist <= max_dist)
        wf = w.astype(jnp.float32)
        n_corr = jnp.sum(wf)
        empty = n_corr == 0.0

        rmse = jnp.sqrt(
            jnp.sum(wf * dist * dist) / jnp.maximum(n_corr, 1.0)
        )
        fitness = n_corr / n_src

        conv = jnp.logical_and(~empty, jnp.abs(c.prev_rmse - rmse) < tolerance)
        do_solve = jnp.logical_and(~empty, ~conv)

        tgt_pts = jnp.take(tgt_xyz, idx, axis=0)
        if point_to_plane:
            tgt_nrm = jnp.take(tgt_normals, idx, axis=0)
            rot_i, trans_i = _plane_solve(c.current, tgt_pts, tgt_nrm, wf)
        else:
            rot_i, trans_i = _svd_rigid_solve(c.current, tgt_pts, wf)

        rot_i = jnp.where(do_solve, rot_i, jnp.eye(3, dtype=jnp.float32))
        trans_i = jnp.where(do_solve, trans_i, jnp.zeros(3, jnp.float32))

        # (all HIGHEST: reduced-precision rounding here accumulates across
        # iterations and stalls convergence)
        hi = jax.lax.Precision.HIGHEST
        new_rot = jax.lax.dot(rot_i, c.rot, precision=hi)
        new_trans = jax.lax.dot(rot_i, c.trans[:, None], precision=hi)[:, 0] + trans_i
        new_current = (
            jax.lax.dot(c.current, rot_i.T, precision=hi) + trans_i[None, :]
        )

        return IcpCarry(
            current=new_current,
            rot=new_rot,
            trans=new_trans,
            prev_rmse=jnp.where(do_solve, rmse, c.prev_rmse),
            last_rmse=jnp.where(empty, c.last_rmse, rmse),
            last_fitness=jnp.where(empty, c.last_fitness, fitness),
            iterations=c.iterations + 1,
            converged=jnp.logical_or(c.converged, conv),
            stop=jnp.logical_or(empty, conv),
        )

    out = jax.lax.while_loop(cond, body, init)
    # Map the centered-frame transform back to raw coordinates:
    # R(p - C) + t + C = R p + (t + C - R C). The C - R C cancellation is
    # offset-scale, so that one tiny computation runs in f64.
    c64 = center.astype(jnp.float64)
    trans_raw = (
        out.trans.astype(jnp.float64) + c64 - out.rot.astype(jnp.float64) @ c64
    ).astype(jnp.float32)
    return (
        out.rot,
        trans_raw,
        out.last_fitness,
        out.last_rmse,
        out.converged,
        out.iterations,
    )


def _pack_icp(out):
    """Pack the 6-tuple ICP result into one f32[16] vector
    ([rot(9), trans(3), fitness, rmse, converged, iterations] — the last
    two exactly representable in f32) so the host API fetches ONE array
    instead of six."""
    rot, trans, fitness, rmse, converged, iters = out
    return jnp.concatenate(
        [
            rot.reshape(9),
            trans,
            jnp.stack(
                [
                    fitness,
                    rmse,
                    converged.astype(jnp.float32),
                    iters.astype(jnp.float32),
                ]
            ),
        ]
    )


def _trim(rows, a):
    """Static head-slice: PointCloud arrays are leading-compact (rows
    [0, len) are the points, the rest masked padding — api.PointCloud
    docstring), so dropping tail padding rows above the 128-row-rounded
    valid count is exact. The NN pass is quadratic in rows (query blocks
    x candidate rows), so trimming 10K points from their 16384 bucket to
    10112 rows cuts the per-iteration work ~2.6x."""
    if a is None or rows is None or rows >= a.shape[0]:
        return a
    return a[:rows]


@partial(jax.jit, static_argnames=("max_iterations", "src_rows", "tgt_rows"))
def icp_point_to_point_packed(
    src_xyz, src_valid, tgt_xyz, tgt_valid, max_iterations: int, tolerance,
    max_dist, *, src_rows: int = None, tgt_rows: int = None,
):
    return _pack_icp(
        _icp_loop(
            _trim(src_rows, src_xyz), _trim(src_rows, src_valid),
            _trim(tgt_rows, tgt_xyz), _trim(tgt_rows, tgt_valid),
            None, max_iterations,
            tolerance, max_dist, point_to_plane=False,
        )
    )


@partial(jax.jit, static_argnames=("max_iterations", "src_rows", "tgt_rows"))
def icp_point_to_plane_packed(
    src_xyz, src_valid, tgt_xyz, tgt_valid, tgt_normals,
    max_iterations: int, tolerance, max_dist, *, src_rows: int = None,
    tgt_rows: int = None,
):
    return _pack_icp(
        _icp_loop(
            _trim(src_rows, src_xyz), _trim(src_rows, src_valid),
            _trim(tgt_rows, tgt_xyz), _trim(tgt_rows, tgt_valid),
            _trim(tgt_rows, tgt_normals),
            max_iterations, tolerance, max_dist, point_to_plane=True,
        )
    )


@partial(jax.jit, static_argnames=("max_iterations",))
def icp_point_to_point_masked(
    src_xyz, src_valid, tgt_xyz, tgt_valid, max_iterations: int, tolerance, max_dist
):
    return _icp_loop(
        src_xyz,
        src_valid,
        tgt_xyz,
        tgt_valid,
        None,
        max_iterations,
        tolerance,
        max_dist,
        point_to_plane=False,
    )


@partial(jax.jit, static_argnames=("max_iterations",))
def icp_point_to_plane_masked(
    src_xyz,
    src_valid,
    tgt_xyz,
    tgt_valid,
    tgt_normals,
    max_iterations: int,
    tolerance,
    max_dist,
):
    return _icp_loop(
        src_xyz,
        src_valid,
        tgt_xyz,
        tgt_valid,
        tgt_normals,
        max_iterations,
        tolerance,
        max_dist,
        point_to_plane=True,
    )
