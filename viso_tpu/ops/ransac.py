"""Vectorized RANSAC: all hypotheses evaluated in one batched pass.

JAX replacement for the OpenCV RANSAC loops the reference calls
(`cv::findEssentialMat` / `cv::findHomography`,
`/root/reference/src/viso.cpp:220-252`). Sequential hypothesize-and-
verify with data-dependent early exit is hostile to XLA; instead we draw
a *fixed* budget of S minimal samples up front, fit all S models with a
vmapped solver, score all S x N residuals as one matmul-shaped pass, and
argmax masked inlier counts. With S ~ hundreds this dominates the
adaptive-termination sequential loop in wall-clock and has fully
static shapes.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from viso_tpu.geometry import epipolar


class RansacResult(NamedTuple):
    model: jnp.ndarray      # best model parameters
    inliers: jnp.ndarray    # (N,) bool inlier mask (respects input mask)
    num_inliers: jnp.ndarray  # scalar int
    best_hypo: jnp.ndarray  # index of the winning hypothesis


def _sample_indices(key, mask, num_hypotheses, sample_size):
    """(S, k) indices drawn from valid correspondences (masked categorical)."""
    logits = jnp.where(mask, 0.0, -jnp.inf)
    return jax.random.categorical(
        key, logits[None, :], shape=(num_hypotheses, sample_size)
    )


def ransac(
    key,
    x1,
    x2,
    mask,
    fit_fn: Callable,
    residual_fn: Callable,
    sample_size: int,
    num_hypotheses: int,
    threshold: float,
):
    """Generic batched RANSAC over correspondences x1, x2 (N, 2).

    fit_fn((k,2),(k,2)) -> model; residual_fn(model, x1, x2) -> (N,) squared
    residuals. Returns RansacResult. All shapes static.
    """
    idx = _sample_indices(key, mask, num_hypotheses, sample_size)
    s1 = x1[idx]  # (S, k, 2)
    s2 = x2[idx]
    models = jax.vmap(fit_fn)(s1, s2)  # (S, ...)
    res = jax.vmap(lambda m: residual_fn(m, x1, x2))(models)  # (S, N)
    inl = (res < threshold) & mask[None, :]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    best_model = jax.tree.map(lambda m: m[best], models)
    return RansacResult(best_model, inl[best], counts[best], best)


@partial(jax.jit, static_argnames=("num_hypotheses", "top_k", "refine_iters"))
def essential_ransac(
    key,
    x1,
    x2,
    mask,
    threshold: float = 1e-5,
    num_hypotheses: int = 2048,
    top_k: int = 8,
    refine_iters: int = 12,
):
    """8-point essential-matrix RANSAC with multi-start manifold refinement.

    `threshold` is the squared Sampson gate in normalized units; the
    reference's 0.3 px at f~520 (viso.h:22, viso.cpp:191) corresponds to
    (0.3/520)^2 ~ 3.3e-7.

    Minimal 8-point fits amplify pixel noise badly in the small-baseline
    regime, so a single best-count hypothesis can sit in a wrong basin
    (observed: 73 deg translation-direction error while covering 30% of
    inliers). The remedy is parallel breadth: thousands of vmapped
    hypotheses, MSAC scoring, then vmapped LM refinement on the essential
    manifold (graduated non-convexity on the robust Sampson cost) from
    the `top_k` hypotheses, keeping the best final robust cost.
    """
    idx = _sample_indices(key, mask, num_hypotheses, 8)
    models = jax.vmap(epipolar.fit_essential)(x1[idx], x2[idx])  # (S,3,3)
    res = jax.vmap(lambda m: epipolar.epipolar_residual(m, x1, x2))(models)
    res = jnp.where(mask[None, :], res, threshold)
    # MSAC score: truncated squared residual (lower = better).
    scores = jnp.sum(jnp.minimum(res, threshold), axis=-1)
    _, top_idx = jax.lax.top_k(-scores, top_k)
    E_top = models[top_idx]
    Rs, ts = epipolar.decompose_essential(E_top)  # (K,4,3,3), (K,4,3)
    R0 = Rs[:, 0]
    t0 = ts[:, 0]
    tau = jnp.sqrt(threshold)
    refit = jax.vmap(
        lambda R, t: epipolar.refine_essential(
            R, t, x1, x2, mask, tau, iters=refine_iters
        )
    )
    R_f, t_f, cost_f = refit(R0, t0)
    best = jnp.argmin(cost_f)
    E = epipolar.essential_from_rt(R_f[best], t_f[best])
    final_res = epipolar.epipolar_residual(E, x1, x2)
    inl = (final_res < threshold) & mask
    return RansacResult(E, inl, jnp.sum(inl), top_idx[best])


@partial(jax.jit, static_argnames=("num_hypotheses",))
def homography_ransac(
    key,
    x1,
    x2,
    mask,
    threshold: float = 1e-5,
    num_hypotheses: int = 256,
):
    """4-point DLT homography RANSAC (ref viso.cpp:238-243)."""
    out = ransac(
        key,
        x1,
        x2,
        mask,
        fit_fn=epipolar.fit_homography,
        residual_fn=epipolar.homography_residual,
        sample_size=4,
        num_hypotheses=num_hypotheses,
        threshold=threshold,
    )
    def lo_step(state, _):
        H, inl, n_inl = state
        H_new = epipolar.fit_homography(x1, x2, weights=inl.astype(x1.dtype))
        res_new = epipolar.homography_residual(H_new, x1, x2)
        inl_new = (res_new < threshold) & mask
        better = jnp.sum(inl_new) >= n_inl
        H = jnp.where(better, H_new, H)
        inl = jnp.where(better, inl_new, inl)
        return (H, inl, jnp.sum(inl)), None

    state = (out.model, out.inliers, out.num_inliers)
    (H, inl, n_inl), _ = jax.lax.scan(lo_step, state, None, length=4)
    return RansacResult(H, inl, n_inl, out.best_hypo)
