"""Sliding-window bundle adjustment: Levenberg-Marquardt + Schur complement.

Realization of the reference's *intended* backend: the dead
g2o skeleton at `/root/reference/include/bundle_adjuster.h` specifies
``BlockSolver<6,3>`` with Levenberg-Marquardt (bundle_adjuster.h:108-119)
and marginalized landmarks, i.e. a Schur complement on the camera-point
system (bundle_adjuster.h:128). That is exactly what this module builds,
with reprojection residuals (and a photometric variant in
`ba_photometric.py` mirroring the 16-dim patch edge of
bundle_adjuster.h:58-106).

Design decisions:
  * **Dense (camera x landmark) observation grid.** A sliding window has
    C <= ~16 cameras, so observations live in (C, L) masked arrays — no
    gathers, no segment sums; every per-observation quantity is a plain
    broadcasted array op, and all block contractions (U, V, W, the Schur
    reduction) are einsums.
  * **Closed-form batched 3x3 landmark inverses** for the marginalization.
  * **Branchless LM**: fixed iteration count, accept/reject by masked
    select, damping updated multiplicatively — no data-dependent control
    flow under jit.
  * The reduced camera system is only (6C x 6C); one dense solve.
    Distribution (parallel/dist_ba.py) shards the landmark dimension and
    psums the reduced system over the mesh — landmark marginalization
    stays shard-local, matching SURVEY.md §2's parallelism plan.

Gauge handling: the first `num_fixed` cameras are frozen (rows/columns
masked out of the reduced system). Monocular windows should freeze two
cameras (pose + scale gauge); stereo/PnP windows one.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from viso_tpu.backend import robust
from viso_tpu.geometry import se3


class BAProblem(NamedTuple):
    """Window state, structure-of-arrays. C cameras, L landmarks."""

    R: jnp.ndarray          # (C, 3, 3) world->camera rotations
    t: jnp.ndarray          # (C, 3)
    points: jnp.ndarray     # (L, 3) world landmarks
    obs_uv: jnp.ndarray     # (C, L, 2) observed *normalized* image coords
    obs_mask: jnp.ndarray   # (C, L) bool — camera c observes landmark l
    cam_mask: jnp.ndarray   # (C,) bool — slot in use
    point_mask: jnp.ndarray  # (L,) bool — slot in use
    # Optional explicit gauge mask: cameras frozen in addition to the
    # first `params.num_fixed` slots (round-robin windows don't keep the
    # oldest camera at index 0). None = only num_fixed applies.
    cam_fixed: jnp.ndarray | None = None


class BAParams(NamedTuple):
    iters: int = 10
    huber: float = 5.0 / 520.0   # robust width in normalized units (~5 px)
    # Truncation: observations with residual norm beyond this get zero
    # weight and a constant cost (gross-outlier gate; Huber's linear tail
    # alone still lets 50-px outliers drag poses by degrees).
    trunc: float = 20.0 / 520.0
    # Graduated non-convexity: the truncation radius starts at
    # `anneal * trunc` and shrinks to `trunc` over the LM iterations, so a
    # badly-initialized camera whose residuals all start beyond the final
    # radius is still pulled in early instead of freezing.
    anneal: float = 4.0
    lam0: float = 1e-4
    lam_up: float = 4.0
    lam_down: float = 0.5
    num_fixed: int = 2           # frozen gauge cameras
    min_depth: float = 1e-3
    # lax.scan unroll for the LM loop: >1 lets XLA fuse/pipeline across
    # iterations of this dependency-latency-bound executable (the
    # per-iteration kernels are tiny; see README "BA ceiling").
    unroll: int = 1
    # Reduced-camera-system solve: "chol" (Cholesky — S is SPD after
    # damping + gauge pinning; no pivoting, one less inner while loop)
    # or "lu".
    solver: str = "chol"


# ---------------------------------------------------------------------------
# Landmark-minor ("L-last") internal layout.
#
# All per-observation tensors keep L as the minor (contiguous) dimension
# and the tiny block indices (2, 6, 3) in leading positions —
# (C, 2, 6, L) rather than (C, L, 2, 6) — so every elementwise pass and
# every reduction over landmarks runs over long contiguous rows.
# ---------------------------------------------------------------------------


def _project_residuals(R, t, points_T, obs_T, valid, min_depth):
    """Residuals r (C, 2, L), validity (C, L), cam points (C, 3, L).

    points_T (3, L); obs_T (C, 2, L) normalized observations.
    """
    p_cam = jnp.einsum("cij,jl->cil", R, points_T) + t[:, :, None]
    z = p_cam[:, 2]
    ok = valid & (z > min_depth)
    z_safe = jnp.where(ok, z, 1.0)
    proj = p_cam[:, :2] / z_safe[:, None]
    r = jnp.where(ok[:, None], proj - obs_T, 0.0)
    return r, ok, p_cam


def _jacobians(p_cam, R):
    """Reprojection Jacobians on normalized coords, L-minor layout.

    Jc (C, 2, 6, L): wrt left-perturbed camera twist [rho, phi].
    Jp (C, 2, 3, L): wrt the world point.
    """
    X, Y, Z = p_cam[:, 0], p_cam[:, 1], p_cam[:, 2]     # (C, L)
    iz = 1.0 / jnp.maximum(Z, 1e-9)
    iz2 = iz * iz
    zero = jnp.zeros_like(X)
    one = jnp.ones_like(X)
    # Row u of d(proj)/d(xi) = [1/Z, 0, -X/Z^2 | -XY/Z^2, 1+X^2/Z^2, -Y/Z]
    # (the standard left-perturbation composite; same algebra the
    # reference's dPixeldXi uses, viso.cpp:640-658, in normalized units).
    Ju = jnp.stack(
        [iz, zero, -X * iz2, -X * Y * iz2, one + X * X * iz2, -Y * iz],
        axis=1,
    )                                                    # (C, 6, L)
    Jv = jnp.stack(
        [zero, iz, -Y * iz2, -(one + Y * Y * iz2), X * Y * iz2, X * iz],
        axis=1,
    )
    Jc = jnp.stack([Ju, Jv], axis=1)                     # (C, 2, 6, L)
    # d(proj)/d(point) = d(proj)/d(p_cam) @ R: rows [R0/Z - X/Z^2 R2,
    # R1/Z - Y/Z^2 R2] with Ri the rows of R.
    R0 = R[:, 0, :, None]                                # (C, 3, 1)
    R1 = R[:, 1, :, None]
    R2 = R[:, 2, :, None]
    Jpu = R0 * iz[:, None] - R2 * (X * iz2)[:, None]     # (C, 3, L)
    Jpv = R1 * iz[:, None] - R2 * (Y * iz2)[:, None]
    Jp = jnp.stack([Jpu, Jpv], axis=1)                   # (C, 2, 3, L)
    return Jc, Jp


def _inv3x3_planes(M):
    """Closed-form 3x3 inverse on (3, 3, L) scalar planes (L-minor)."""
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    d, e, f = M[1, 0], M[1, 1], M[1, 2]
    g, h, i = M[2, 0], M[2, 1], M[2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = jnp.where(jnp.abs(det) < 1e-18, 1e-18, det)
    rows = [
        jnp.stack([A, B, C], axis=0),
        jnp.stack([D, E, F], axis=0),
        jnp.stack([G, H, I], axis=0),
    ]
    return jnp.stack(rows, axis=0) / det[None, None]


def _inv3x3(M):
    """Batched closed-form 3x3 inverse via adjugate."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = jnp.where(jnp.abs(det) < 1e-18, 1e-18, det)
    adj = jnp.stack(
        [
            jnp.stack([A, B, C], axis=-1),
            jnp.stack([D, E, F], axis=-1),
            jnp.stack([G, H, I], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def compute_cost(
    prob: BAProblem, params: BAParams = BAParams(), trunc=None, axis_name=None
):
    """Total robust reprojection cost (scalar) and per-obs validity count.

    With `axis_name`, landmark-sharded partial sums are `psum`ed over the
    mesh axis (distributed BA, parallel/dist_ba.py).
    """
    valid = prob.obs_mask & prob.cam_mask[:, None] & prob.point_mask[None, :]
    r, ok, _ = _project_residuals(
        prob.R, prob.t, prob.points.T, prob.obs_uv.transpose(0, 2, 1),
        valid, params.min_depth,
    )
    r_norm = jnp.linalg.norm(r, axis=1)
    # Tukey biweight: redescending, constant beyond `trunc`, so gross and
    # borderline outliers neither pull the solution nor flip LM accepts.
    trunc = params.trunc if trunc is None else trunc
    rho = robust.tukey_cost(r_norm, trunc)
    cost = jnp.sum(jnp.where(ok, rho, 0.0))
    n_obs = jnp.sum(ok)
    if axis_name is not None:
        cost = jax.lax.psum(cost, axis_name)
        n_obs = jax.lax.psum(n_obs, axis_name)
    return cost, n_obs


def _lm_iteration(
    R, t, points, prob: BAProblem, lam, trunc, params: BAParams, C,
    axis_name=None,
):
    """One LM step: build normal equations, Schur-reduce, solve, update.

    Also returns the robust cost AT THE INPUT STATE, computed from this
    pass's own residuals — the LM accept test needs it, and a separate
    compute_cost pass would redo the projection (a third residual sweep
    per iteration) and, distributed, spend an extra collective.

    With `axis_name` (landmark-sharded distributed mode): ONE fused
    `psum` per iteration carries the camera blocks (U, g_c), the Schur
    cross terms, and the cost scalar across devices; everything
    landmark-indexed (V, V^-1, W, Y, g_p, delta_p) stays shard-local —
    exactly the layout SURVEY.md §2 prescribes. The reduced 6Cx6C
    camera solve is replicated on every device.
    """
    valid = prob.obs_mask & prob.cam_mask[:, None] & prob.point_mask[None, :]
    r, ok, p_cam = _project_residuals(
        R, t, points.T, prob.obs_uv.transpose(0, 2, 1), valid,
        params.min_depth,
    )
    r_norm = jnp.linalg.norm(r, axis=1)
    cost = jnp.sum(
        jnp.where(ok, robust.tukey_cost(r_norm, trunc), 0.0)
    )
    w = jnp.where(ok, robust.tukey_weight(r_norm, trunc), 0.0)  # (C, L)
    Jc, Jp = _jacobians(p_cam, R)                       # (C,2,6,L), (C,2,3,L)
    okf = ok.astype(r.dtype)
    Jc = Jc * okf[:, None, None]
    Jp = Jp * okf[:, None, None]

    # Block normal equations; every contraction keeps L (and the obs row
    # index) as the reduced axes so the intermediates stay L-minor.
    # The point-block terms are kept as per-column SLABS — W_k = W[:, :, k]
    # of shape (C, 6, L) — because a materialized (C, 6, 3, L) array pads
    # its sublane dim 3 -> 8 (2.7x traffic) and forces XLA to lower the
    # Schur contraction as loops instead of three big matmuls.
    Jc_w = Jc * w[:, None, None]
    U = jnp.einsum("cail,cajl->cij", Jc_w, Jc)
    Jp_w = Jp * w[:, None, None]
    V = jnp.einsum("cail,cajl->ijl", Jp_w, Jp)          # (3, 3, L)
    W = [
        Jc_w[:, 0] * Jp[:, 0, k][:, None] + Jc_w[:, 1] * Jp[:, 1, k][:, None]
        for k in range(3)
    ]                                                   # 3 x (C, 6, L)
    g_c = -jnp.einsum("cail,cal->ci", Jc_w, r)
    g_p = -jnp.einsum("cail,cal->il", Jp_w, r)          # (3, L)

    # Gauge/freeze mask: first num_fixed cameras, explicit cam_fixed
    # slots, and unused slots.
    free = prob.cam_mask & (jnp.arange(C) >= params.num_fixed)
    if prob.cam_fixed is not None:
        free = free & ~prob.cam_fixed

    delta_c, delta_p, cost = schur_solve(
        U, V, W, g_c, g_p, lam, prob.point_mask, free, axis_name=axis_name,
        fold_scalar=cost, solver=params.solver,
    )

    R_new, t_new = jax.vmap(se3.left_update)(delta_c, R, t)
    points_new = points + delta_p.T
    return R_new, t_new, points_new, cost


def schur_solve(
    U, V, W, g_c, g_p, lam, point_mask, free, axis_name=None,
    fold_scalar=None, solver="chol",
):
    """Damped Schur-complement solve of a 6/3 block system, slab form.

    Shared by the reprojection and photometric (ba_photometric.py)
    backends — the block structure is the reference's stated
    ``BlockSolver<6,3>`` + marginalized landmarks intent
    (bundle_adjuster.h:108,128); only the residuals differ.

    U (C, 6, 6) camera blocks; V (3, 3, L) landmark-block scalar planes;
    W: list of three (C, 6, L) slabs (column k of the (6, 3) cross
    blocks); g_c (C, 6); g_p (3, L); free (C,) bool — cameras optimized.
    Returns (delta_c (C, 6), delta_p (3, L), fold_scalar), zero for
    masked slots.

    With `axis_name` (landmark-sharded distributed mode, inside
    shard_map): ONE fused psum carries the (6C)^2 + 6C reduced camera
    system, the U/g_c camera blocks, and the caller's optional
    `fold_scalar` (e.g. the local robust cost — folding it here spares
    a separate scalar collective per LM iteration); everything
    landmark-indexed stays shard-local.
    """
    C = U.shape[0]
    dtype = U.dtype

    trV = (V[0, 0] + V[1, 1] + V[2, 2]) / 3.0 + 1e-6    # (L,)
    V_d = V + (lam * trV) * jnp.eye(3, dtype=dtype)[:, :, None]

    # Marginalize landmarks (Schur): batched closed-form 3x3 inverses on
    # (3, 3, L) planes; Y = W V^-1 built slab-by-slab, and the Schur
    # cross term -Y W^T reduced as three (6C, L) x (L, 6C) matmuls.
    V_inv = _inv3x3_planes(V_d) * point_mask[None, None, :]
    Y = [
        sum(W[k] * V_inv[k, j][None, None] for k in range(3))
        for j in range(3)
    ]                                                   # 3 x (C, 6, L)
    S_cross = -sum(
        jnp.einsum("cil,djl->cdij", Y[j], W[j]) for j in range(3)
    )
    b_cross = jnp.stack(
        [jnp.einsum("cil,l->ci", Y[j], g_p[j]) for j in range(3)]
    ).sum(0)
    if axis_name is not None:
        # ONE collective: everything camera-indexed (shard-summed
        # partials) plus the folded scalar crosses the interconnect
        # together.
        if fold_scalar is None:
            U, g_c, S_cross, b_cross = jax.lax.psum(
                (U, g_c, S_cross, b_cross), axis_name
            )
        else:
            U, g_c, S_cross, b_cross, fold_scalar = jax.lax.psum(
                (U, g_c, S_cross, b_cross, fold_scalar), axis_name
            )

    # LM damping (multiplicative on the diagonal) — after the psum so
    # the damping sees the GLOBAL camera blocks.
    eye6 = jnp.eye(6, dtype=dtype)
    U_d = U + lam * (jnp.einsum("cii->c", U) / 6.0 + 1e-6)[:, None, None] * eye6
    S = S_cross.at[jnp.arange(C), jnp.arange(C)].add(U_d)
    b_red = g_c - b_cross

    free_f = free.astype(dtype)
    S = S * free_f[:, None, None, None] * free_f[None, :, None, None]
    S = S.at[jnp.arange(C), jnp.arange(C)].add(
        (1.0 - free_f)[:, None, None] * eye6
    )
    b_red = b_red * free_f[:, None]

    # Dense reduced camera solve (6C x 6C).
    S_flat = S.transpose(0, 2, 1, 3).reshape(6 * C, 6 * C)
    if solver == "chol":
        # S is SPD after damping + gauge pinning; Cholesky halves the
        # factorization work and avoids LU pivoting's serial chain.
        chol = jnp.linalg.cholesky(S_flat)
        delta_c = jax.scipy.linalg.cho_solve(
            (chol, True), b_red.reshape(6 * C)
        ).reshape(C, 6)
    else:
        delta_c = jnp.linalg.solve(S_flat, b_red.reshape(6 * C)).reshape(C, 6)
    delta_c = jnp.where(jnp.isfinite(delta_c), delta_c, 0.0) * free_f[:, None]

    # Back-substitute landmark updates (all (., L)-plane arithmetic).
    rhs = g_p - jnp.stack(
        [jnp.einsum("cil,ci->l", W[j], delta_c) for j in range(3)]
    )                                                   # (3, L)
    delta_p = jnp.einsum("ijl,jl->il", V_inv, rhs)      # (3, L)
    delta_p = jnp.where(jnp.isfinite(delta_p), delta_p, 0.0)
    delta_p = delta_p * point_mask[None, :]
    return delta_c, delta_p, fold_scalar


def solve_impl(prob: BAProblem, params: BAParams = BAParams(), axis_name=None):
    """Run LM for `params.iters` iterations. Returns (BAProblem, info dict).

    Branchless accept/reject: a rejected step keeps the state and raises
    the damping, mirroring g2o's Levenberg strategy
    (bundle_adjuster.h:115-117) without data-dependent control flow.
    `axis_name` enables the landmark-sharded distributed path (call from
    inside `shard_map`; see parallel/dist_ba.py).
    """
    C = prob.R.shape[0]
    # GNC schedule for the truncation radius.
    truncs = params.trunc * params.anneal ** jnp.linspace(1.0, 0.0, params.iters)

    def body(state, trunc):
        R, t, points, lam = state
        # _lm_iteration returns the cost at (R, t, points) from its own
        # residual pass — two residual sweeps per iteration (step build
        # + accept test) instead of three, and distributed, ONE fused
        # normal-equation psum instead of separate U/Schur/cost
        # collectives (VERDICT r4 #4a).
        R_n, t_n, p_n, cost = _lm_iteration(
            R, t, points, prob, lam, trunc, params, C, axis_name
        )
        new_cost, _ = compute_cost(
            prob._replace(R=R_n, t=t_n, points=p_n), params, trunc, axis_name
        )
        accept = new_cost < cost
        R = jnp.where(accept, R_n, R)
        t = jnp.where(accept, t_n, t)
        points = jnp.where(accept, p_n, points)
        lam = jnp.where(
            accept,
            jnp.maximum(lam * params.lam_down, 1e-9),
            jnp.minimum(lam * params.lam_up, 1e6),
        )
        return (R, t, points, lam), jnp.minimum(new_cost, cost)

    cost0, n_obs = compute_cost(prob, params, None, axis_name)
    init = (prob.R, prob.t, prob.points, jnp.asarray(params.lam0, prob.R.dtype))
    (R, t, points, lam), cost_hist = jax.lax.scan(
        body, init, truncs, unroll=params.unroll
    )
    cost, _ = compute_cost(
        prob._replace(R=R, t=t, points=points), params, None, axis_name
    )
    out = prob._replace(R=R, t=t, points=points)
    info = {
        "initial_cost": cost0,
        "final_cost": cost,
        "cost_history": cost_hist,
        "num_obs": n_obs,
        "final_lambda": lam,
    }
    return out, info


solve = jax.jit(solve_impl, static_argnames=("params",))
