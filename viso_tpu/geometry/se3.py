"""SO(3)/SE(3) Lie-group operations, batched and jit-friendly.

JAX replacement for the Sophus usage in the reference
(`/root/reference/src/viso.cpp:114,737`, `include/common.h:10-33`):
``Hat`` (common.h:26-33), ``MakeSE3`` (common.h:10-17), and the
``SE3d::exp(update) * T`` left-multiplicative updates used by the
direct tracker (viso.cpp:737) and the dead bundle adjuster
(`include/bundle_adjuster.h:50-55`).

All functions broadcast over leading batch dimensions and are safe under
`jit`/`vmap`/`grad`. Rotations are 3x3 matrices; a transform is the pair
``(R, t)`` mapping world->camera: ``x_cam = R @ x_world + t``. Small-angle
paths use Taylor expansions selected with `jnp.where` so gradients stay
finite at theta = 0.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def hat(w):
    """Skew-symmetric matrix of w (..., 3) -> (..., 3, 3). Ref common.h:26-33."""
    w = jnp.asarray(w)
    zeros = jnp.zeros_like(w[..., 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -w[..., 2], w[..., 1]], axis=-1),
            jnp.stack([w[..., 2], zeros, -w[..., 0]], axis=-1),
            jnp.stack([-w[..., 1], w[..., 0], zeros], axis=-1),
        ],
        axis=-2,
    )


def vee(W):
    """Inverse of `hat`: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _taylor_coeffs(theta_sq):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor-safe.

    The Taylor branch engages below theta ~ 1e-2: in float32, 1-cos(t)
    underflows to 0 for t < ~5e-4 and t-sin(t) is pure cancellation noise
    well beyond that, so a switch near machine epsilon (the f64 habit) is
    catastrophically late here. At t = 1e-2 the two-term Taylor error is
    ~1e-10 — far below f32 trig roundoff.
    """
    theta = jnp.sqrt(theta_sq + _EPS)
    small = theta_sq < 1e-4
    A = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / (theta_sq + _EPS))
    C = jnp.where(small, 1.0 / 6.0 - theta_sq / 120.0, (theta - jnp.sin(theta)) / (theta_sq * theta + _EPS))
    return A, B, C


def so3_exp(w):
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    w = jnp.asarray(w)
    theta_sq = jnp.sum(w * w, axis=-1)
    A, B, _ = _taylor_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    Robust near theta = 0 (Taylor) and theta = pi (diagonal extraction).
    """
    R = jnp.asarray(R)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    # d(arccos)/dx is infinite at x = +-1: an exact-identity input (e.g. a
    # masked/padded pose-graph edge) would poison forward/reverse AD with
    # NaN *through* the jnp.where below (both branches' tangents are
    # computed). Keep arccos's input strictly inside (-1, 1) and feed the
    # near-identity branch a smooth theta^2 surrogate instead of theta.
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    skew = vee(R - jnp.swapaxes(R, -1, -2))          # = 2 sin(theta) axis
    near_zero = cos_theta > 1.0 - 5e-5               # theta < ~1e-2
    theta = jnp.where(near_zero, 0.0, jnp.arccos(cos_theta))
    # |skew|^2 = 4 sin^2(theta): smooth everywhere, and near zero
    # theta^2 = |skew|^2/4 + O(theta^4) — more than enough for the
    # quadratic Taylor term below.
    theta_sq_t = jnp.sum(skew * skew, axis=-1) * 0.25
    # Generic branch: theta / (2 sin theta) * (R - R^T)^vee
    sin_theta = jnp.sin(theta)
    generic_scale = jnp.where(
        near_zero,
        0.5 + theta_sq_t / 12.0,  # Taylor of theta/(2 sin theta)
        theta / (2.0 * sin_theta + _EPS),
    )
    w_generic = generic_scale[..., None] * skew
    # Near-pi branch: w = theta * axis, axis from largest diagonal of (R + I)/2
    S = R + jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    diag = jnp.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], axis=-1)
    k = jnp.argmax(diag, axis=-1)
    idx = jnp.broadcast_to(k[..., None, None], S.shape[:-1] + (1,))
    col = jnp.take_along_axis(S, idx, axis=-1)[..., 0]
    axis = col / (jnp.linalg.norm(col, axis=-1, keepdims=True) + _EPS)
    # Fix sign so that it is consistent with the off-diagonal skew part.
    sign_ref = vee(R - jnp.swapaxes(R, -1, -2))
    sign = jnp.where(jnp.sum(sign_ref * axis, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    w_pi = theta[..., None] * axis * sign
    near_pi = (jnp.pi - theta) < 1e-3
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def se3_exp(xi):
    """Twist (..., 6) [rho, phi] (trans first, rot last) -> (R, t).

    Convention matches Sophus' SE3::exp used at viso.cpp:737: the first
    three components are translational, the last three rotational.
    """
    xi = jnp.asarray(xi)
    rho, phi = xi[..., :3], xi[..., 3:]
    theta_sq = jnp.sum(phi * phi, axis=-1)
    A, B, C = _taylor_coeffs(theta_sq)
    W = hat(phi)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return R, t


def se3_log(R, t):
    """(R, t) -> twist (..., 6) [rho, phi]; inverse of `se3_exp`."""
    phi = so3_log(R)
    theta_sq = jnp.sum(phi * phi, axis=-1)
    A, B, _ = _taylor_coeffs(theta_sq)
    W = hat(phi)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), W.shape)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    # Same f32 rationale as _taylor_coeffs: 1 - A/(2B) is catastrophic
    # cancellation for small theta; switch to Taylor well before it.
    coef = jnp.where(
        theta_sq < 1e-4,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - A / (2.0 * B + _EPS)) / (theta_sq + _EPS),
    )
    V_inv = eye - 0.5 * W + coef[..., None, None] * W2
    rho = jnp.einsum("...ij,...j->...i", V_inv, t)
    return jnp.concatenate([rho, phi], axis=-1)


def compose(R1, t1, R2, t2):
    """(R1,t1) o (R2,t2): apply T2 first, then T1."""
    R = R1 @ R2
    t = jnp.einsum("...ij,...j->...i", R1, t2) + t1
    return R, t


def inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t)


def transform(R, t, points):
    """Apply (R, t) to points (..., 3)."""
    return jnp.einsum("...ij,...j->...i", R, points) + t


def left_update(xi, R, t):
    """T <- exp(xi) * T — the GN update rule of viso.cpp:737."""
    dR, dt = se3_exp(xi)
    return compose(dR, dt, R, t)


def make_matrix(R, t):
    """Assemble a 4x4 homogeneous transform (ref common.h:10-17 MakeSE3)."""
    R = jnp.asarray(R)
    batch = R.shape[:-2]
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4)
    )
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def from_matrix(T):
    """Split a 4x4 homogeneous transform into (R, t)."""
    return T[..., :3, :3], T[..., :3, 3]


def relative(Ra, ta, Rb, tb):
    """T_ab = T_a * T_b^{-1}: transform taking frame-b camera coords to frame-a."""
    Rbi, tbi = inverse(Rb, tb)
    return compose(Ra, ta, Rbi, tbi)
