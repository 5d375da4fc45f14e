"""Pyramidal Lucas-Kanade optical flow, batched over keypoints.

Batched replacement for the reference's hand-written tracker
(`/root/reference/src/viso.cpp:259-391`): per-keypoint Gauss-Newton on an
8x8 patch (half_patch_size=4, viso.h:25), inverse-compositional Jacobian
(viso.cpp:297-303), 10 iterations (viso.cpp:266), coarse-to-fine over 4
pyramid levels with the estimate upsampled between levels
(viso.cpp:353-391), and a photometric-error success gate
(viso.cpp:332-336, photometric_error_thresh viso.h:26).

Redesign: the per-keypoint loop becomes one batched computation —
every iteration samples all N keypoints' patches from cached windows,
solves all 2x2 systems in closed form elementwise, and applies
masked updates. Early termination ("cost increased -> stop",
viso.cpp:323-325) becomes best-cost rollback, which is branchless and
strictly no worse. Inverse-compositional mode hoists the template
gradient/Hessian out of the iteration loop entirely.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from viso_tpu.geometry import sampling
from viso_tpu.ops import pyramid as pyr_mod


class LKParams(NamedTuple):
    half_patch: int = 4          # ref viso.h:25
    iters: int = 10              # ref viso.cpp:266
    levels: int = 4              # ref keyframe.h:20
    # Mean squared photometric error gate per pixel; the reference gates
    # SSD over the 8x8 patch at (8^2)*15^2 (viso.h:26) = 225/pixel.
    err_thresh: float = 225.0
    min_det: float = 1e-4


def _solve2x2(H, b, min_det):
    """Batched closed-form solve of H (..., 2, 2) x = b (..., 2)."""
    det = H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
    ok = jnp.abs(det) > min_det
    safe = jnp.where(ok, det, 1.0)
    x0 = (H[..., 1, 1] * b[..., 0] - H[..., 0, 1] * b[..., 1]) / safe
    x1 = (H[..., 0, 0] * b[..., 1] - H[..., 1, 0] * b[..., 0]) / safe
    return jnp.stack([x0, x1], axis=-1), ok


def _single_level(img_ref, img_cur, kp_ref, flow0, params: LKParams):
    """One pyramid level of batched inverse-compositional LK.

    kp_ref: (N, 2) keypoint positions at this level's scale.
    flow0:  (N, 2) initial displacement estimates.
    Returns (flow (N, 2), mean_sq_err (N,), ok (N,)).
    """
    half = params.half_patch
    win = min(4 * half + 8, *img_ref.shape)
    # Template (ref image) and warm-start (cur image) windows in ONE
    # indexed extraction; the GN loop then samples from the cached
    # windows with zero gathers.
    n = kp_ref.shape[0]
    win2, base2 = sampling.extract_windows_indexed(
        jnp.stack([img_ref, img_cur]),
        jnp.concatenate([jnp.zeros(n, jnp.int32), jnp.ones(n, jnp.int32)]),
        jnp.concatenate([kp_ref, kp_ref + flow0]),
        win,
    )
    ref_win, cur_win = win2[:n], win2[n:]
    ref_base, cur_base = base2[:n], base2[n:]
    T, gx, gy = sampling.sample_patch_grid_with_grad(ref_win, ref_base, kp_ref, half)
    # Zero-mean template (ZSSD) — bias-invariant matching, same
    # rationale as ops/align.py: exposure drift between the frames
    # must not bias the step or saturate the err gate.
    T = T - jnp.mean(T, axis=(-1, -2), keepdims=True)
    # Template Hessian, hoisted out of the loop (inverse-compositional,
    # ref viso.cpp:297-303 computes J from the *reference* image too).
    H00 = jnp.sum(gx * gx, axis=(-1, -2))
    H01 = jnp.sum(gx * gy, axis=(-1, -2))
    H11 = jnp.sum(gy * gy, axis=(-1, -2))

    def solve(b0, b1):
        det = H00 * H11 - H01 * H01
        ok = jnp.abs(det) > params.min_det
        safe = jnp.where(ok, det, 1.0)
        d0 = (H11 * b0 - H01 * b1) / safe
        d1 = (H00 * b1 - H01 * b0) / safe
        delta = jnp.stack([d0, d1], axis=-1)
        return delta, ok

    def body(_, state):
        flow, best_flow, best_cost = state
        I = sampling.sample_patch_grid(cur_win, cur_base, kp_ref + flow, half)
        r = I - jnp.mean(I, axis=(-1, -2), keepdims=True) - T
        cost = jnp.mean(r * r, axis=(-1, -2))
        improved = cost < best_cost
        best_flow = jnp.where(improved[:, None], flow, best_flow)
        best_cost = jnp.minimum(cost, best_cost)
        b0 = jnp.sum(gx * r, axis=(-1, -2))
        b1 = jnp.sum(gy * r, axis=(-1, -2))
        delta, ok = solve(b0, b1)
        delta = jnp.where(
            (ok & jnp.all(jnp.isfinite(delta), axis=-1))[:, None], delta, 0.0
        )
        # Inverse-compositional translation update: d <- d - delta.
        return flow - delta, best_flow, best_cost

    init = (flow0, flow0, jnp.full(kp_ref.shape[:1], jnp.inf, kp_ref.dtype))
    flow, best_flow, best_cost = jax.lax.fori_loop(
        0, params.iters, body, init, unroll=True
    )
    # Final candidate also competes for best (mirrors "apply then check").
    I = sampling.sample_patch_grid(cur_win, cur_base, kp_ref + flow, half)
    r = I - jnp.mean(I, axis=(-1, -2), keepdims=True) - T
    cost = jnp.mean(r * r, axis=(-1, -2))
    improved = cost < best_cost
    best_flow = jnp.where(improved[:, None], flow, best_flow)
    best_cost = jnp.minimum(cost, best_cost)
    ok = best_cost < params.err_thresh
    return best_flow, best_cost, ok


@partial(jax.jit, static_argnames=("params",))
def track(pyr_ref, pyr_cur, kp_ref, mask, params: LKParams = LKParams()):
    """Track keypoints from ref to cur through the pyramids.

    pyr_ref, pyr_cur: tuples of (H/2^l, W/2^l) images (ops.pyramid).
    kp_ref: (N, 2) float (u, v) at level 0; mask: (N,) valid flags.
    Returns (kp_cur (N, 2), err (N,), ok (N,)).

    Coarse-to-fine with flow upsampling between levels, matching
    viso.cpp:372-390 (scales {1,.5,.25,.125}, estimate carried across
    levels); success additionally requires the tracked point to land
    inside the level-0 image with a patch border.
    """
    levels = len(pyr_ref)
    flow = jnp.zeros_like(kp_ref)
    err = jnp.zeros(kp_ref.shape[:1], kp_ref.dtype)
    ok = jnp.ones(kp_ref.shape[:1], dtype=bool)
    for level in range(levels - 1, -1, -1):
        scale = jnp.asarray(pyr_mod.SCALES[level], kp_ref.dtype) if level < len(
            pyr_mod.SCALES
        ) else 0.5**level
        kp_l = kp_ref * scale
        flow, err, ok_l = _single_level(
            pyr_ref[level], pyr_cur[level], kp_l, flow, params
        )
        ok = ok_l  # only the finest level's gate matters (ref gates per level)
        if level > 0:
            flow = flow * 2.0
    kp_cur = kp_ref + flow
    H0, W0 = pyr_ref[0].shape
    inside = (
        (kp_cur[:, 0] >= params.half_patch)
        & (kp_cur[:, 0] < W0 - params.half_patch)
        & (kp_cur[:, 1] >= params.half_patch)
        & (kp_cur[:, 1] < H0 - params.half_patch)
    )
    return kp_cur, err, ok & inside & mask
