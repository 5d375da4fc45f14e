"""Photometric (direct) bundle adjustment: LM + Schur on patch residuals.

This is the realization of the reference's *stated* backend design: the
dead g2o skeleton (`/root/reference/include/bundle_adjuster.h`) defines
``EdgeDirectProjection`` — a 16-dimensional photometric error over a 4x4
patch between a point and a pose (bundle_adjuster.h:58-106) — with
``BlockSolver<6,3>`` + Levenberg-Marquardt (":108-119") and marginalized
landmarks => Schur complement (":128"). Here each landmark stores a 4x4
template sampled from its anchor keyframe, and every observing camera
contributes a 16-dim residual of current-image intensities at the
landmark's projection.

Design (same playbook as backend/ba.py + ops/direct.py):
  * **Zero-gather inner loop.** One 16x16 window per (camera, landmark)
    observation is extracted ONCE per solve (batched dynamic_slice)
    around the initial projections; every LM
    iteration then evaluates the moving patch samples and their exact
    bilinear-surface gradients as separable hat-weight matmuls against
    the cached windows. Projections that drift out of their window are
    masked, not gathered.
  * **Landmark-minor layout.** All per-observation tensors keep L in the
    minor dimension — r (C, P2, L), Jc (C, P2, 6, L), Jp as three
    (C, P2, L) slabs — so reductions over landmarks are contiguous.
  * **Shared Schur solve.** The damped 6/3 marginalization + reduced
    camera solve is ba.schur_solve — identical machinery, different
    residuals, exactly the reference's BlockSolver<6,3> split.
  * **Scale-warped patches.** The sample footprint scales with the
    anchor/current depth ratio (frozen per solve), so forward motion
    does not mismatch the template by tens of gray levels at the truth.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from viso_tpu.backend import robust
from viso_tpu.backend.ba import _inv3x3, schur_solve  # noqa: F401 (_inv3x3
# re-exported: historical import site for other modules/tests)
from viso_tpu.geometry import camera as cam_mod
from viso_tpu.geometry import sampling, se3


class PhotoBAProblem(NamedTuple):
    R: jnp.ndarray          # (C, 3, 3)
    t: jnp.ndarray          # (C, 3)
    points: jnp.ndarray     # (L, 3)
    images: jnp.ndarray     # (C, H, W) the keyframe images (one level)
    template: jnp.ndarray   # (L, P*P) patch intensities from anchor kf
    anchor_idx: jnp.ndarray  # (L,) keyframe that owns each template
    obs_mask: jnp.ndarray   # (C, L)
    cam_mask: jnp.ndarray   # (C,)
    point_mask: jnp.ndarray  # (L,)
    cam_fixed: jnp.ndarray | None = None


class PhotoBAParams(NamedTuple):
    iters: int = 8
    half_patch: int = 2          # 4x4 patch = 16-dim residual (ref :58)
    huber: float = 12.0          # gray levels
    lam0: float = 1e-3
    lam_up: float = 4.0
    lam_down: float = 0.5
    num_fixed: int = 1
    min_depth: float = 1e-2
    # Cached-window geometry: each observation's samples live in a
    # win x win window extracted at the INITIAL projection; projections
    # drifting beyond the window during LM are masked for that iteration.
    win: int = 16


def make_template(images, anchor_idx, points, R, t, intr, half_patch=2):
    """Sample each landmark's template patch from its anchor keyframe.

    images (C, H, W); anchor_idx (L,) keyframe index per landmark.
    Returns (L, P*P) template.
    """
    p_cam = jnp.einsum("lij,lj->li", R[anchor_idx], points) + t[anchor_idx]
    uv, depth = cam_mod.project(p_cam, intr)
    offs = sampling.patch_offsets(half_patch, uv.dtype).reshape(-1, 2)
    uv_patch = uv[:, None, :] + offs[None]
    return sampling.bilinear_indexed(images, anchor_idx, uv_patch)


class _Windows(NamedTuple):
    """Per-observation cached sampling state (N = C*L, flattened)."""

    win: jnp.ndarray       # (N, w, w) image windows
    base: jnp.ndarray      # (N, 2) float window origins (x0, y0)
    scale: jnp.ndarray     # (N,) frozen patch-footprint scale
    cover: jnp.ndarray     # (C, L) window coverage possible at all


def _project_planes(R, t, points_T, intr):
    """p_cam (C, 3, L), pixel u, v (C, L) — L-minor throughout."""
    p_cam = jnp.einsum("cij,jl->cil", R, points_T) + t[:, :, None]
    z = jnp.maximum(p_cam[:, 2], 1e-6)
    u = intr.fx * p_cam[:, 0] / z + intr.cx
    v = intr.fy * p_cam[:, 1] / z + intr.cy
    return p_cam, u, v


def _precompute_windows(prob: PhotoBAProblem, intr, params: PhotoBAParams):
    """Extract one window per observation at the initial projections."""
    C, H, W = prob.images.shape
    L = prob.points.shape[0]
    w0 = params.win
    _, u0, v0 = _project_planes(prob.R, prob.t, prob.points.T, intr)
    uv0 = jnp.stack([u0.reshape(-1), v0.reshape(-1)], axis=-1)  # (N, 2)
    # In-image centers only (the extractor clips origins; a far-out
    # projection would otherwise silently sample the border window).
    cover = (
        prob.obs_mask
        & (u0 >= 0) & (u0 <= W - 1) & (v0 >= 0) & (v0 <= H - 1)
    )
    uv_safe = jnp.clip(
        uv0,
        jnp.zeros(2, uv0.dtype),
        jnp.array([W - 1.0, H - 1.0], uv0.dtype),
    )
    cam_idx = jnp.broadcast_to(jnp.arange(C)[:, None], (C, L)).reshape(-1)
    tiles, base = sampling.extract_windows_indexed(
        prob.images, cam_idx, uv_safe, w0
    )
    # Frozen scale warp: anchor depth / current depth at the initial
    # state (clipped; beyond 2x the 4x4 template is the wrong content
    # anyway and the robust kernel should own it).
    d_anchor = (
        jnp.einsum("lj,lj->l", prob.points,
                   prob.R[prob.anchor_idx][:, 2, :])
        + prob.t[prob.anchor_idx][:, 2]
    )
    z0 = (
        jnp.einsum("cj,jl->cl", prob.R[:, 2, :], prob.points.T)
        + prob.t[:, 2:3]
    )
    scale = jnp.clip(
        d_anchor[None, :] / jnp.maximum(z0, 1e-3), 0.5, 2.0
    ).reshape(-1)
    return _Windows(
        win=tiles, base=base.astype(uv0.dtype), scale=scale, cover=cover
    )


def _sampled_residuals(prob, wins: _Windows, R, t, points, intr,
                       params: PhotoBAParams, need_grad: bool):
    """r_T (C, P2, L), gx_T/gy_T (C, P2, L) or None, ok (C, L), p_cam."""
    C, H, W = prob.images.shape
    L = points.shape[0]
    half = params.half_patch
    w0 = params.win
    p_cam, u, v = _project_planes(R, t, points.T, intr)
    uv = jnp.stack([u.reshape(-1), v.reshape(-1)], axis=-1)     # (N, 2)
    vals, gx, gy = sampling.sample_patch_grid_scaled_with_grad(
        wins.win, wins.base, uv, half, wins.scale
    )
    # Validity: base gates + positive depth + the full scaled patch
    # (incl. bilinear support) inside the cached window.
    ext = half * wins.scale.reshape(C, L) + 1.0
    bx = wins.base[:, 0].reshape(C, L)
    by = wins.base[:, 1].reshape(C, L)
    ok = (
        wins.cover
        & prob.cam_mask[:, None]
        & prob.point_mask[None, :]
        & (p_cam[:, 2] > params.min_depth)
        & (u - ext >= bx) & (u + ext <= bx + w0 - 1)
        & (v - ext >= by) & (v + ext <= by + w0 - 1)
    )
    P2 = (2 * half) * (2 * half)

    def to_T(x):  # (N, P, P) -> (C, P2, L)
        return x.reshape(C, L, P2).transpose(0, 2, 1)

    tmpl_T = prob.template.T[None]                               # (1, P2, L)
    r_T = jnp.where(ok[:, None, :], to_T(vals) - tmpl_T, 0.0)
    if not need_grad:
        return r_T, None, None, ok, p_cam
    return r_T, to_T(gx), to_T(gy), ok, p_cam


def compute_cost(prob: PhotoBAProblem, intr, params: PhotoBAParams,
                 wins: _Windows = None, R=None, t=None, points=None):
    R = prob.R if R is None else R
    t = prob.t if t is None else t
    points = prob.points if points is None else points
    if wins is None:
        wins = _precompute_windows(prob, intr, params)
    r_T, _, _, ok, _ = _sampled_residuals(
        prob, wins, R, t, points, intr, params, need_grad=False
    )
    r_norm = jnp.linalg.norm(r_T, axis=1)                        # (C, L)
    return jnp.sum(
        jnp.where(ok, robust.huber_cost(r_norm, params.huber * 4), 0.0)
    )


def _lm_iteration(prob, wins, R, t, points, intr, lam, params):
    C = R.shape[0]
    r_T, gx_T, gy_T, ok, p_cam = _sampled_residuals(
        prob, wins, R, t, points, intr, params, need_grad=True
    )
    r_norm = jnp.linalg.norm(r_T, axis=1)
    w = jnp.where(ok, robust.huber_weight(r_norm, params.huber * 4), 0.0)

    # Projection Jacobians in pixel units, composite L-minor form (same
    # algebra as ba._jacobians / the reference's dPixeldXi,
    # viso.cpp:640-658, times the focal lengths).
    X, Y, Z = p_cam[:, 0], p_cam[:, 1], p_cam[:, 2]              # (C, L)
    iz = 1.0 / jnp.maximum(Z, 1e-6)
    iz2 = iz * iz
    zero = jnp.zeros_like(X)
    one = jnp.ones_like(X)
    fx, fy = intr.fx, intr.fy
    Ju = fx * jnp.stack(
        [iz, zero, -X * iz2, -X * Y * iz2, one + X * X * iz2, -Y * iz],
        axis=1,
    )                                                            # (C, 6, L)
    Jv = fy * jnp.stack(
        [zero, iz, -Y * iz2, -(one + Y * Y * iz2), X * Y * iz2, X * iz],
        axis=1,
    )
    R0 = R[:, 0, :, None]
    R1 = R[:, 1, :, None]
    R2 = R[:, 2, :, None]
    Jpu = fx * (R0 * iz[:, None] - R2 * (X * iz2)[:, None])     # (C, 3, L)
    Jpv = fy * (R1 * iz[:, None] - R2 * (Y * iz2)[:, None])

    # Chain rule with the exact bilinear-surface gradient planes.
    Jc = (
        gx_T[:, :, None, :] * Ju[:, None]
        + gy_T[:, :, None, :] * Jv[:, None]
    )                                                   # (C, P2, 6, L)
    Jp = [
        gx_T * Jpu[:, k][:, None] + gy_T * Jpv[:, k][:, None]
        for k in range(3)
    ]                                                   # 3 x (C, P2, L)

    Jc_w = Jc * w[:, None, None, :]
    Jp_w = [Jp[k] * w[:, None, :] for k in range(3)]
    U = jnp.einsum("cpil,cpjl->cij", Jc_w, Jc)
    V = jnp.stack([
        jnp.stack([
            jnp.einsum("cpl,cpl->l", Jp_w[i], Jp[j]) for j in range(3)
        ])
        for i in range(3)
    ])                                                  # (3, 3, L)
    W = [jnp.einsum("cpil,cpl->cil", Jc_w, Jp[k]) for k in range(3)]
    g_c = -jnp.einsum("cpil,cpl->ci", Jc_w, r_T)
    g_p = -jnp.stack(
        [jnp.einsum("cpl,cpl->l", Jp_w[k], r_T) for k in range(3)]
    )                                                   # (3, L)

    free = prob.cam_mask & (jnp.arange(C) >= params.num_fixed)
    if prob.cam_fixed is not None:
        free = free & ~prob.cam_fixed
    delta_c, delta_p, _ = schur_solve(
        U, V, W, g_c, g_p, lam, prob.point_mask, free
    )
    R_new, t_new = jax.vmap(se3.left_update)(delta_c, R, t)
    return R_new, t_new, points + delta_p.T


def solve_impl(
    prob: PhotoBAProblem, intr, params: PhotoBAParams = PhotoBAParams()
):
    """Photometric LM + Schur over the window. Returns (problem, info).

    Unjitted body — call from inside an enclosing jit (slam/engine.py
    fuses it into the keyframe-insertion kernel) or use `solve`.
    """
    wins = _precompute_windows(prob, intr, params)

    def body(state, _):
        R, t, points, lam, cost = state
        R_n, t_n, p_n = _lm_iteration(
            prob, wins, R, t, points, intr, lam, params
        )
        new_cost = compute_cost(prob, intr, params, wins, R_n, t_n, p_n)
        accept = new_cost < cost
        R = jnp.where(accept, R_n, R)
        t = jnp.where(accept, t_n, t)
        points = jnp.where(accept, p_n, points)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(
            accept,
            jnp.maximum(lam * params.lam_down, 1e-9),
            jnp.minimum(lam * params.lam_up, 1e6),
        )
        return (R, t, points, lam, cost), cost

    cost0 = compute_cost(prob, intr, params, wins)
    init = (
        prob.R, prob.t, prob.points,
        jnp.asarray(params.lam0, prob.R.dtype), cost0,
    )
    (R, t, points, lam, cost), hist = jax.lax.scan(
        body, init, None, length=params.iters
    )
    return prob._replace(R=R, t=t, points=points), {
        "initial_cost": cost0,
        "final_cost": cost,
        "cost_history": hist,
    }


solve = jax.jit(solve_impl, static_argnames=("params",))
