"""PCA normal estimation with an analytic Cardano 3x3 eigensolver.

JAX redesign of the reference normals crate
(ref: crates/normals/src/estimate.rs): the rayon per-point loop becomes one
batched pipeline — batched KNN -> per-point covariance (a batched
einsum) -> vectorized Cardano smallest-eigenvector -> viewpoint orientation.

The reference computes the eigensolve in f64 for stability
(ref: estimate.rs:147-153). The hot path stays f32, so instead the
covariance matrix is normalized by its largest absolute entry before the f32
eigensolve — eigenvectors are invariant under scaling, and the normalization
keeps intermediates O(1) so f32 has full relative precision where the
reference relied on f64 headroom. Thresholds are therefore relative rather
than the reference's absolute 1e-30 cutoffs.

The reference's eigenvalue-selection quirk — the eigenvalue of smallest
*magnitude*, not the algebraically smallest (ref: estimate.rs:191-197) — is
reproduced exactly, as is the 3-way row-pair fallback for the eigenvector
cross products (ref: estimate.rs:199-237).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_PP_EPS = 1e-12  # relative analogue of the reference's 1e-30 absolute cutoff
_LEN_EPS = 1e-16


def cardano_smallest_eigvec(cov):
    """Eigenvector of the smallest-|lambda| eigenvalue of symmetric [N,3,3].

    Vectorized port of ``smallest_eigenvector_3x3``
    (ref: crates/normals/src/estimate.rs:139-238). Returns f32[N,3]
    (unnormalized direction; caller normalizes).
    """
    vx, vy, vz = cardano_smallest_eigvec_comps(
        cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
        cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2],
    )
    return jnp.stack([vx, vy, vz], axis=1)


def cardano_smallest_eigvec_comps(c00, c01, c02, c11, c12, c22):
    """Component-rows form of `cardano_smallest_eigvec`: six 1-D symmetric
    covariance components in, three 1-D eigenvector components out. The
    fused pipelines stay in flat row layout throughout (no [N, 3, 3]
    intermediate), so the whole eigensolve is pure elementwise work.
    """
    # Scale-normalize: eigenvectors of A and A/s are identical.
    scale = jnp.max(
        jnp.stack(
            [jnp.abs(c) for c in (c00, c01, c02, c11, c12, c22)]
        ),
        axis=0,
    )
    degenerate_scale = scale <= 0.0
    s = jnp.where(degenerate_scale, 1.0, scale)
    a00, a01, a02 = c00 / s, c01 / s, c02 / s
    a11, a12, a22 = c11 / s, c12 / s, c22 / s

    m = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - m, a11 - m, a22 - m

    q = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    ) / 2.0
    p = (
        b00 * b00
        + b11 * b11
        + b22 * b22
        + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    ) / 6.0
    pp = jnp.maximum(p, 0.0)
    near_identity = pp < _PP_EPS

    sqrt_p = jnp.sqrt(jnp.where(near_identity, 1.0, pp))
    det_ratio = jnp.clip(q / (sqrt_p**3), -1.0, 1.0)
    phi = jnp.arccos(det_ratio) / 3.0

    two_pi_3 = 2.0 * jnp.pi / 3.0
    eig0 = m + 2.0 * sqrt_p * jnp.cos(phi + two_pi_3)  # smallest
    eig2 = m + 2.0 * sqrt_p * jnp.cos(phi)  # largest
    eig1 = 3.0 * m - eig0 - eig2

    # The reference picks the eigenvalue of smallest |lambda| — reproduce it.
    abs0, abs1, abs2 = jnp.abs(eig0), jnp.abs(eig1), jnp.abs(eig2)
    lam = jnp.where(
        (abs0 <= abs1) & (abs0 <= abs2),
        eig0,
        jnp.where(abs1 <= abs2, eig1, eig2),
    )

    r00, r11, r22 = a00 - lam, a11 - lam, a22 - lam

    def cross01():
        return (
            a01 * a12 - r11 * a02,
            a02 * a01 - a12 * r00,
            r00 * r11 - a01 * a01,
        )

    def cross02():
        return (
            a01 * r22 - a12 * a02,
            a02 * a02 - r22 * r00,
            r00 * a12 - a01 * a02,
        )

    def cross12():
        return (
            r11 * r22 - a12 * a12,
            a12 * a02 - r22 * a01,
            a01 * a12 - r11 * a02,
        )

    e01 = cross01()
    e02 = cross02()
    e12 = cross12()
    l01 = e01[0] * e01[0] + e01[1] * e01[1] + e01[2] * e01[2]
    l02 = e02[0] * e02[0] + e02[1] * e02[1] + e02[2] * e02[2]
    l12 = e12[0] * e12[0] + e12[1] * e12[1] + e12[2] * e12[2]

    bad = near_identity | degenerate_scale
    out = []
    for comp in range(3):
        dflt = jnp.float32(1.0 if comp == 2 else 0.0)
        v = jnp.where(
            l01 >= _LEN_EPS,
            e01[comp],
            jnp.where(
                l02 >= _LEN_EPS,
                e02[comp],
                jnp.where(l12 >= _LEN_EPS, e12[comp], dflt),
            ),
        )
        out.append(jnp.where(bad, dflt, v))
    return tuple(out)


def normals_from_moment_rows(m1r, m2r, cnt, xyz, viewpoint):
    """Oriented unit PCA normals from query-centered KNN moment ROWS
    (m1r f32[3, N], m2r f32[6, N] in xx,yy,zz,xy,xz,yz order, cnt
    f32[N]) — the fused sweep kernels' output layout. All math runs on
    1-D components (see `cardano_smallest_eigvec_comps` for why); the
    only [N, 3] materialization is the final output stack. Semantics
    match the reference per-point loop (ref:
    crates/normals/src/estimate.rs:42-107): degenerate/neighborless
    rows -> (0, 0, 1), viewpoint orientation flip on dot < 0."""
    denom = jnp.maximum(cnt, 1.0)
    mx, my, mz = m1r[0] / denom, m1r[1] / denom, m1r[2] / denom
    # cov = M2 - cnt * mean mean^T (query-relative moments)
    vx, vy, vz = cardano_smallest_eigvec_comps(
        m2r[0] - cnt * mx * mx,
        m2r[3] - cnt * mx * my,
        m2r[4] - cnt * mx * mz,
        m2r[1] - cnt * my * my,
        m2r[5] - cnt * my * mz,
        m2r[2] - cnt * mz * mz,
    )
    length = jnp.sqrt(vx * vx + vy * vy + vz * vz)
    ok_len = length > 1e-10
    inv_len = 1.0 / jnp.maximum(length, 1e-30)
    ux = jnp.where(ok_len, vx * inv_len, vx)
    uy = jnp.where(ok_len, vy * inv_len, vy)
    uz = jnp.where(ok_len, vz * inv_len, vz)
    dot = (
        ux * (viewpoint[0] - xyz[:, 0])
        + uy * (viewpoint[1] - xyz[:, 1])
        + uz * (viewpoint[2] - xyz[:, 2])
    )
    flip = jnp.where(dot < 0.0, -1.0, 1.0)
    none_found = cnt < 1.0
    return jnp.stack(
        [
            jnp.where(none_found, 0.0, ux * flip),
            jnp.where(none_found, 0.0, uy * flip),
            jnp.where(none_found, 1.0, uz * flip),
        ],
        axis=1,
    )


@jax.jit
def normals_from_knn(xyz, nbr_idx, nbr_valid, viewpoint, query_xyz=None):
    """Per-point PCA normals from precomputed KNN neighbor lists.

    Mirrors the reference per-point pipeline: neighbor centroid ->
    3x3 covariance -> smallest eigenvector -> unit normalize -> flip toward
    viewpoint (ref: crates/normals/src/estimate.rs:42-107). Points with zero
    neighbors get (0, 0, 1) without orientation (ref :49-51).

    ``query_xyz`` (defaults to ``xyz``) holds the query positions when the
    neighbor lists belong to a SUBSET of the cloud (engine rescue path).
    """
    if query_xyz is None:
        query_xyz = xyz
    pts = jnp.take(xyz, nbr_idx, axis=0)  # [N, k, 3]
    use = nbr_valid[:, :, None]
    cnt = jnp.sum(nbr_valid.astype(jnp.float32), axis=1)
    denom = jnp.maximum(cnt, 1.0)
    centroid = jnp.sum(jnp.where(use, pts, 0.0), axis=1) / denom[:, None]
    d = jnp.where(use, pts - centroid[:, None, :], 0.0)
    cov = jnp.einsum(
        "nki,nkj->nij", d, d, precision=jax.lax.Precision.HIGHEST
    )

    vec = cardano_smallest_eigvec(cov)
    length = jnp.linalg.norm(vec, axis=1)
    unit = jnp.where(
        (length > 1e-10)[:, None], vec / jnp.maximum(length, 1e-30)[:, None], vec
    )

    to_vp = viewpoint[None, :] - query_xyz
    dot = jnp.sum(unit * to_vp, axis=1)
    oriented = jnp.where((dot < 0.0)[:, None], -unit, unit)

    no_neighbors = cnt < 1.0
    return jnp.where(
        no_neighbors[:, None],
        jnp.array([0.0, 0.0, 1.0], xyz.dtype)[None, :],
        oriented,
    )
