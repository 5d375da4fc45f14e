"""Two-view epipolar geometry: essential matrix, homography, decompositions.

JAX replacement for the reference's OpenCV calls in
`PoseEstimation2d2d` (`/root/reference/src/viso.cpp:178-256`):
`cv::findEssentialMat` -> batched 8-point solver (vmapped over RANSAC
minimal sets, see ops/ransac.py), `cv::recoverPose` -> `decompose_essential`
+ cheirality in the motion selector, `cv::findHomography` /
`cv::decomposeHomographyMat` -> `fit_homography` / `decompose_homography`,
and `RecoverPoseHomography` (viso.cpp:147-175).

All solvers take *normalized* image coordinates (K^-1 applied,
viso.cpp:46-48) and use eigh-of-normal-matrix null spaces, which batch
better than per-sample SVDs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _weighted_nullvec(A, w=None):
    """Smallest eigenvector of A^T diag(w) A for A (..., m, 9)."""
    if w is not None:
        A = A * w[..., None]
    AtA = jnp.einsum("...ki,...kj->...ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    return vecs[..., :, 0]


def _epipolar_rows(x1, x2):
    """Constraint rows a s.t. a . vec(E) = 0 for x2^T E x1 = 0.

    x1, x2: (..., N, 2) normalized coords. Returns (..., N, 9).
    """
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = jnp.ones_like(u1)
    return jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], axis=-1
    )


def fit_essential(x1, x2, weights=None):
    """8-point essential matrix on (..., N, 2) normalized correspondences.

    Returns E (..., 3, 3) projected onto the essential manifold
    (singular values (1, 1, 0)). N >= 8 (use N = 8 inside RANSAC).
    """
    A = _epipolar_rows(x1, x2)
    e = _weighted_nullvec(A, weights)
    E = e.reshape(e.shape[:-1] + (3, 3))
    U, s, Vt = jnp.linalg.svd(E)
    s_proj = jnp.stack(
        [jnp.ones_like(s[..., 0]), jnp.ones_like(s[..., 0]), jnp.zeros_like(s[..., 0])],
        axis=-1,
    )
    return U @ (s_proj[..., :, None] * Vt)


def epipolar_residual(E, x1, x2):
    """Sampson distance of correspondences to E (..., N).

    This is the statistically-correct analogue of the reference's RANSAC
    threshold (0.3 px normalized, viso.cpp:191,220).
    """
    ones = jnp.ones_like(x1[..., :1])
    p1 = jnp.concatenate([x1, ones], axis=-1)
    p2 = jnp.concatenate([x2, ones], axis=-1)
    Ex1 = jnp.einsum("...ij,...nj->...ni", E, p1)
    Etx2 = jnp.einsum("...ji,...nj->...ni", E, p2)
    x2Ex1 = jnp.sum(p2 * Ex1, axis=-1)
    denom = (
        Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    )
    return (x2Ex1**2) / (denom + 1e-12)


def signed_sampson(E, x1, x2):
    """First-order geometric (signed) epipolar distance (..., N)."""
    ones = jnp.ones_like(x1[..., :1])
    p1 = jnp.concatenate([x1, ones], axis=-1)
    p2 = jnp.concatenate([x2, ones], axis=-1)
    Ex1 = jnp.einsum("...ij,...nj->...ni", E, p1)
    Etx2 = jnp.einsum("...ji,...nj->...ni", E, p2)
    num = jnp.sum(p2 * Ex1, axis=-1)
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / jnp.sqrt(den + 1e-18)


def essential_from_rt(R, t):
    """E = [t]x R (up to scale)."""
    zeros = jnp.zeros_like(t[..., 0])
    tx = jnp.stack(
        [
            jnp.stack([zeros, -t[..., 2], t[..., 1]], axis=-1),
            jnp.stack([t[..., 2], zeros, -t[..., 0]], axis=-1),
            jnp.stack([-t[..., 1], t[..., 0], zeros], axis=-1),
        ],
        axis=-2,
    )
    return tx @ R


def refine_essential(R0, t0, x1, x2, mask, tau, iters: int = 12, anneal: float = 8.0):
    """LM refinement of E on the essential manifold (R, t on sphere).

    Minimizes a Cauchy-robust sum of squared signed Sampson distances,
    with the robust width annealed from `anneal * tau` down to `tau`
    (graduated non-convexity — escapes the biased minimal-sample basin
    that plain IRLS on the algebraic error gets stuck in). Branchless
    step acceptance; safe under vmap for multi-start refinement.

    Returns (R, t, robust_cost).
    """
    from viso_tpu.geometry import se3 as _se3

    ones = jnp.ones_like(x1[..., :1])
    p1 = jnp.concatenate([x1, ones], axis=-1)
    p2 = jnp.concatenate([x2, ones], axis=-1)
    m = mask.astype(x1.dtype)

    def residual(theta, R, t):
        Rc = _se3.so3_exp(theta[:3]) @ R
        tc = t + theta[3:]
        E = essential_from_rt(Rc, tc)
        Ex1 = p1 @ E.T
        Etx2 = p2 @ E
        num = jnp.sum(p2 * Ex1, axis=-1)
        den = (
            Ex1[..., 0] ** 2
            + Ex1[..., 1] ** 2
            + Etx2[..., 0] ** 2
            + Etx2[..., 1] ** 2
        )
        return num / jnp.sqrt(den + 1e-18)

    def robust_cost(r, tau_i):
        w = tau_i**2 / (tau_i**2 + r * r)
        return jnp.sum(m * w * r * r)

    jac = jax.jacfwd(residual)
    taus = tau * anneal ** jnp.linspace(1.0, 0.0, iters)

    def step(state, tau_i):
        R, t, lam = state
        th0 = jnp.zeros(6, x1.dtype)
        r = residual(th0, R, t)
        J = jac(th0, R, t)
        w = m * tau_i**2 / (tau_i**2 + r * r)
        Jw = J * w[:, None]
        H = Jw.T @ J + lam * jnp.eye(6, dtype=x1.dtype)
        g = Jw.T @ r
        d = jnp.linalg.solve(H, -g)
        d = jnp.where(jnp.all(jnp.isfinite(d)), d, jnp.zeros_like(d))
        c0 = robust_cost(r, tau_i)
        c1 = robust_cost(residual(d, R, t), tau_i)
        accept = c1 < c0
        R_new = jnp.where(accept, _se3.so3_exp(d[:3]) @ R, R)
        t_new = jnp.where(accept, t + d[3:], t)
        t_new = t_new / (jnp.linalg.norm(t_new) + 1e-12)
        lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-6), jnp.minimum(lam * 10.0, 1e3))
        return (R_new, t_new, lam), None

    lam0 = jnp.asarray(1e-3, x1.dtype)
    (R, t, _), _ = jax.lax.scan(step, (R0, t0 / (jnp.linalg.norm(t0) + 1e-12), lam0), taus)
    final_cost = robust_cost(residual(jnp.zeros(6, x1.dtype), R, t), tau)
    return R, t, final_cost


def decompose_essential(E):
    """E -> 4 candidate motions (R (4,3,3), t (4,3)), |t| = 1.

    The classic U W V^T construction behind `cv::recoverPose`
    (viso.cpp:231-234); cheirality selection happens in the motion
    selector (ops/twoview.py), mirroring `SelectMotion` (viso.cpp:520-638).
    """
    U, _, Vt = jnp.linalg.svd(E)
    # Enforce proper rotations.
    detU = jnp.linalg.det(U)
    detVt = jnp.linalg.det(Vt)
    U = U * jnp.where(detU < 0, -1.0, 1.0)[..., None, None]
    Vt = Vt * jnp.where(detVt < 0, -1.0, 1.0)[..., None, None]
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    Rs = jnp.stack([R1, R1, R2, R2], axis=-3)
    ts = jnp.stack([t, -t, t, -t], axis=-2)
    return Rs, ts


def _homography_rows(x1, x2):
    """DLT rows for x2 ~ H x1; (..., N, 2) -> (..., 2N, 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    zero = jnp.zeros_like(u1)
    one = jnp.ones_like(u1)
    r1 = jnp.stack([-u1, -v1, -one, zero, zero, zero, u2 * u1, u2 * v1, u2], axis=-1)
    r2 = jnp.stack([zero, zero, zero, -u1, -v1, -one, v2 * u1, v2 * v1, v2], axis=-1)
    rows = jnp.concatenate([r1[..., None, :], r2[..., None, :]], axis=-2)
    return rows.reshape(rows.shape[:-3] + (rows.shape[-3] * 2, 9))


def fit_homography(x1, x2, weights=None):
    """DLT homography on (..., N, 2) normalized correspondences, N >= 4."""
    A = _homography_rows(x1, x2)
    if weights is not None:
        weights = jnp.repeat(weights, 2, axis=-1)
    h = _weighted_nullvec(A, weights)
    H = h.reshape(h.shape[:-1] + (3, 3))
    return H / (H[..., 2:3, 2:3] + 1e-12)


def homography_residual(H, x1, x2):
    """Symmetric-free transfer error |x2 - H x1| (..., N), squared."""
    ones = jnp.ones_like(x1[..., :1])
    p1 = jnp.concatenate([x1, ones], axis=-1)
    Hx1 = jnp.einsum("...ij,...nj->...ni", H, p1)
    proj = Hx1[..., :2] / (Hx1[..., 2:3] + 1e-12)
    return jnp.sum((proj - x2) ** 2, axis=-1)


def decompose_homography(H):
    """Homography -> 8 candidate motions (R (8,3,3), t (8,3), n (8,3)).

    Faugeras-style SVD decomposition (the machinery behind
    `cv::decomposeHomographyMat`, viso.cpp:244-252). H must act on
    normalized coordinates. Returns all sign combinations; invalid/planar-
    degenerate candidates simply score poorly in the motion selector.
    """
    U, s, Vt = jnp.linalg.svd(H)
    d1, d2, d3 = s[..., 0], s[..., 1], s[..., 2]
    # Normalize by the middle singular value.
    detU = jnp.linalg.det(U)
    detV = jnp.linalg.det(Vt)
    sgn = detU * detV
    d1 = d1 / d2
    d3 = d3 / d2
    eps = 1e-9
    x1 = jnp.sqrt(jnp.clip((d1**2 - 1.0) / (d1**2 - d3**2 + eps), 0.0, None))
    x3 = jnp.sqrt(jnp.clip((1.0 - d3**2) / (d1**2 - d3**2 + eps), 0.0, None))
    sin_t = jnp.sqrt(
        jnp.clip((d1**2 - 1.0) * (1.0 - d3**2), 0.0, None)
    ) / ((d1 + d3) * 1.0 + eps)
    cos_t = (1.0 + d1 * d3) / (d1 + d3 + eps)

    Rs, ts, ns = [], [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            n_p = jnp.stack([e1 * x1, jnp.zeros_like(x1), e3 * x3], axis=-1)
            st = e1 * e3 * sin_t
            Rp = jnp.zeros(H.shape[:-2] + (3, 3), dtype=H.dtype)
            Rp = Rp.at[..., 0, 0].set(cos_t)
            Rp = Rp.at[..., 0, 2].set(-st)
            Rp = Rp.at[..., 1, 1].set(1.0)
            Rp = Rp.at[..., 2, 0].set(st)
            Rp = Rp.at[..., 2, 2].set(cos_t)
            tp = (d1 - d3) * jnp.stack([e1 * x1, jnp.zeros_like(x1), -e3 * x3], axis=-1)
            V = jnp.swapaxes(Vt, -1, -2)
            R = sgn[..., None, None] * (U @ Rp @ Vt)
            t = jnp.einsum("...ij,...j->...i", U, tp)
            n = jnp.einsum("...ij,...j->...i", V, n_p)
            Rs.append(R)
            ts.append(t)
            ns.append(n)
            # Also the "negated normal" twin (t, n) -> (-t, -n).
            Rs.append(R)
            ts.append(-t)
            ns.append(-n)
    Rs = jnp.stack(Rs, axis=-3)
    ts = jnp.stack(ts, axis=-2)
    tn = jnp.linalg.norm(ts, axis=-1, keepdims=True)
    ts = ts / (tn + 1e-12)
    return Rs, ts, jnp.stack(ns, axis=-2)
