"""Map-to-frame feature alignment (LK refinement against keyframes).

Batched replacement for the reference's `LKAlignment` /
`LKAlignmentSingle` (`/root/reference/src/viso.cpp:768-925`): for every
visible map point, pick the keyframe with the best viewing angle as the
photometric reference (viso.cpp:782-806), then run coarse-to-fine 2-DoF
Gauss-Newton patch alignment of the predicted current-frame position
(viso.cpp:845-925, inverse-compositional, <=100 iters).

Redesign: alignment pairs are a fixed-size masked batch; each pair reads
its own reference keyframe through one flat indexed gather
(`sampling.bilinear_indexed`) instead of per-pair image pointers, and the
per-pair GN loop is the same batched best-cost-rollback iteration as
ops/lk.py.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from viso_tpu.geometry import camera as cam_mod
from viso_tpu.geometry import sampling


class AlignParams(NamedTuple):
    half_patch: int = 4
    iters: int = 10
    err_thresh: float = 225.0
    min_det: float = 1e-4
    max_shift: float = 4.0  # reject refinements that moved further than this
    # Finest pyramid levels to run. The warm start comes from direct
    # tracking and max_shift gates the result at +-4 px, so coarse levels
    # (which exist to absorb large displacements) are dead weight; each
    # level costs the same (fixed N and window size).
    levels: int = 2


def select_reference_keyframes(points_w, kf_R, kf_t, kf_mask, obs_mask=None):
    """Best-viewing-angle keyframe per point (ref viso.cpp:782-806).

    points_w (L, 3); kf_R (K, 3, 3); kf_t (K, 3); kf_mask (K,).
    obs_mask (K, L), optional: restrict the choice to keyframes that
    actually observe the landmark (a keyframe without an observation has
    no template patch to align against).
    Returns (kf_idx (L,), cos_angle (L,)); cos_angle is -inf for points
    with no eligible keyframe.
    """
    p_cam = jnp.einsum("kij,lj->kli", kf_R, points_w) + kf_t[:, None, :]
    cosang = cam_mod.viewing_cos(p_cam)  # (K, L)
    eligible = kf_mask[:, None] & (p_cam[..., 2] > 1e-3)
    if obs_mask is not None:
        eligible = eligible & obs_mask
    cosang = jnp.where(eligible, cosang, -jnp.inf)
    k_best = jnp.argmax(cosang, axis=0)
    return k_best, jnp.max(cosang, axis=0)


def _align_level(imgs_ref, k_idx, uv_ref, img_cur, flow0, params: AlignParams):
    """One level of batched 2-DoF GN alignment.

    imgs_ref: (K, h, w) stacked keyframe images at this pyramid level.
    k_idx: (N,) reference keyframe per pair; uv_ref: (N, 2) template pos.
    flow0: (N, 2) current displacement of the target from uv_ref.
    """
    half = params.half_patch
    # Alignment shifts are gated at max_shift (~4 px): +-4 margin suffices.
    win = min(2 * half + 8, imgs_ref.shape[1], imgs_ref.shape[2], *img_cur.shape)
    # Template (from each pair's reference keyframe) and current-frame
    # windows in ONE indexed extraction: the current image rides as one
    # more entry of the stacked image set. Separable axis-aligned
    # sampling against the cached windows keeps the GN loop gather-free.
    n = uv_ref.shape[0]
    K = imgs_ref.shape[0]
    imgs_all = jnp.concatenate([imgs_ref, img_cur[None]], axis=0)
    win2, base2 = sampling.extract_windows_indexed(
        imgs_all,
        jnp.concatenate([k_idx.astype(jnp.int32), jnp.full(n, K, jnp.int32)]),
        jnp.concatenate([uv_ref, uv_ref + flow0]),
        win,
    )
    ref_win, cur_win = win2[:n], win2[n:]
    ref_base, cur_base = base2[:n], base2[n:]
    T, gx, gy = sampling.sample_patch_grid_with_grad(ref_win, ref_base, uv_ref, half)
    # Zero-mean template (ZSSD): the residual below subtracts each
    # patch's mean from BOTH sides, so a bias between the keyframe
    # template and the current frame (auto-exposure drift — the
    # keyframe can be several frames old) neither biases the 2-DoF
    # step nor saturates the err gate. Displacement information lives
    # in the gradient-weighted residual, which the mean removal leaves
    # intact. Measured on the exposure-drift orbit bench: plain I - T
    # alignment was the dominant ATE term (4x clean).
    T = T - jnp.mean(T, axis=(-1, -2), keepdims=True)
    # 2x2 normal matrix per pair, kept as scalar planes.
    H00 = jnp.sum(gx * gx, axis=(-1, -2))
    H01 = jnp.sum(gx * gy, axis=(-1, -2))
    H11 = jnp.sum(gy * gy, axis=(-1, -2))

    def body(_, state):
        flow, best_flow, best_cost = state
        I = sampling.sample_patch_grid(cur_win, cur_base, uv_ref + flow, half)
        r = I - jnp.mean(I, axis=(-1, -2), keepdims=True) - T
        cost = jnp.mean(r * r, axis=(-1, -2))
        improved = cost < best_cost
        best_flow = jnp.where(improved[:, None], flow, best_flow)
        best_cost = jnp.minimum(cost, best_cost)
        b0 = jnp.sum(gx * r, axis=(-1, -2))
        b1 = jnp.sum(gy * r, axis=(-1, -2))
        det = H00 * H11 - H01 * H01
        ok = jnp.abs(det) > params.min_det
        safe = jnp.where(ok, det, 1.0)
        d0 = (H11 * b0 - H01 * b1) / safe
        d1 = (H00 * b1 - H01 * b0) / safe
        delta = jnp.stack([d0, d1], axis=-1)
        delta = jnp.where(
            (ok & jnp.all(jnp.isfinite(delta), axis=-1))[:, None], delta, 0.0
        )
        return flow - delta, best_flow, best_cost

    init = (flow0, flow0, jnp.full(uv_ref.shape[:1], jnp.inf, uv_ref.dtype))
    flow, best_flow, best_cost = jax.lax.fori_loop(0, params.iters, body, init)
    I = sampling.sample_patch_grid(cur_win, cur_base, uv_ref + flow, half)
    I = I - jnp.mean(I, axis=(-1, -2), keepdims=True)
    cost = jnp.mean((I - T) ** 2, axis=(-1, -2))
    improved = cost < best_cost
    best_flow = jnp.where(improved[:, None], flow, best_flow)
    best_cost = jnp.minimum(cost, best_cost)
    return best_flow, best_cost


@partial(jax.jit, static_argnames=("params",))
def align(
    kf_pyramids,
    k_idx,
    uv_ref,
    cur_pyramid,
    uv_cur0,
    mask,
    params: AlignParams = AlignParams(),
):
    """Refine predicted current-frame positions against reference keyframes.

    kf_pyramids: tuple over levels of (K, h_l, w_l) stacked keyframe images.
    k_idx: (N,) reference keyframe index per pair.
    uv_ref: (N, 2) template positions in the reference keyframe (level 0).
    cur_pyramid: tuple over levels of (h_l, w_l) current-frame images.
    uv_cur0: (N, 2) predicted positions in the current frame (level 0).
    Returns (uv_refined (N, 2), err (N,), ok (N,)).
    """
    levels = min(params.levels, len(cur_pyramid))
    flow = (uv_cur0 - uv_ref) * (0.5 ** (levels - 1))
    for level in range(levels - 1, -1, -1):
        s = 0.5**level
        flow, err = _align_level(
            kf_pyramids[level], k_idx, uv_ref * s, cur_pyramid[level], flow, params
        )
        if level > 0:
            flow = flow * 2.0
    uv_out = uv_ref + flow
    H0, W0 = cur_pyramid[0].shape
    shift = jnp.linalg.norm(uv_out - uv_cur0, axis=-1)
    ok = (
        mask
        & (err < params.err_thresh)
        & (shift <= params.max_shift)
        & cam_mod.is_inside(uv_out, H0, W0, border=params.half_patch)
    )
    return uv_out, err, ok
