"""Stereo matching along rectified epipolar lines.

The reference is monocular-only; stereo VO (BASELINE.json config 2)
needs per-feature disparity. Batched design: for N keypoints and D
candidate disparities, sample all (N, D) patch SSDs in one fused gather
batch (no per-feature loops), argmin over D, then sub-pixel refine with
a parabola fit on the SSD curve — everything static-shape.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from viso_tpu.geometry import sampling


class StereoParams(NamedTuple):
    max_disparity: int = 128
    half_patch: int = 4
    # Maximum acceptable mean SSD per pixel for a valid match.
    max_cost: float = 400.0
    min_disparity: float = 0.25   # sub-pixel disparities below are unusable


def scanline_strips(img, bx, by, h: int, w: int):
    """(N, h, w) windows of img at in-bounds origins (bx, by) (N,):
    one batched dynamic_slice, named `extract_windows` in traces."""
    with jax.named_scope("extract_windows"):
        return jax.vmap(
            lambda x0, y0: jax.lax.dynamic_slice(img, (y0, x0), (h, w))
        )(bx, by)


@partial(jax.jit, static_argnames=("params",))
def match(img_left, img_right, kp_left, mask, params: StereoParams = StereoParams()):
    """Match left-image keypoints into the right image (rectified pair).

    kp_left: (N, 2) pixel coords in the left image.
    Returns (disparity (N,), cost (N,), ok (N,)).
    Depth follows as  z = f * baseline / disparity.

    One scanline window of width D+P per keypoint (batched
    dynamic_slice), resampled once onto the keypoint's fractional grid
    with separable hat-weight matmuls; every disparity's patch is then a
    *static* slice of the resampled strip — zero gathers in the search
    (the naive formulation gathers (N, D, P, P) samples).
    """
    half = params.half_patch
    P = 2 * half
    D = params.max_disparity
    H, W = img_left.shape
    N = kp_left.shape[0]
    lwin, lbase = sampling.extract_windows(img_left, kp_left, min(P + 4, H, W))
    tmpl = sampling.sample_patch_grid(lwin, lbase, kp_left, half)      # (N,P,P)

    # Right scanline strip covering disparities 0..D-1.
    WH = min(P + 4, H)
    WW = min(D + P + 4, W)
    u = kp_left[:, 0]
    v = kp_left[:, 1]
    bx = jnp.clip(jnp.floor(u).astype(jnp.int32) - (D - 1) - half - 1, 0, W - WW)
    by = jnp.clip(jnp.floor(v).astype(jnp.int32) - half - 2, 0, H - WH)

    rwin = scanline_strips(img_right, bx, by, WH, WW)      # (N,WH,WW)
    # Resample the strip once onto the keypoint's fractional grid:
    # rows v-half..v+half-1, cols u-(D-1)-half..u+half-1.
    S = D + P - 1
    rows = v[:, None] - half + jnp.arange(P, dtype=v.dtype)[None]      # (N,P)
    cols = (
        u[:, None] - (D - 1) - half + jnp.arange(S, dtype=u.dtype)[None]
    )                                                                   # (N,S)
    Wy = sampling._hat_weights(rows - by[:, None].astype(v.dtype), WH)  # N,P,WH
    Wx = sampling._hat_weights(cols - bx[:, None].astype(u.dtype), WW)  # N,S,WW
    strip = jnp.einsum("npy,nyx,nsx->nps", Wy, rwin, Wx)                # (N,P,S)
    # SSD for disparity d = mean over the patch of (strip slice - tmpl)^2;
    # the slice start is D-1-d (all static slices).
    strip_sq = strip * strip
    # Sliding sums over the column axis via cumsum.
    csum = jnp.cumsum(
        jnp.pad(jnp.sum(strip_sq, axis=1), ((0, 0), (1, 0))), axis=-1
    )                                                                   # (N,S+1)
    win_sq = csum[:, P:] - csum[:, :-P]                                 # (N,D) at start s
    # Cross-correlation term WITHOUT materializing a (N, D, P, P)
    # candidate stack: cross[n, s] = sum_q sum_p strip[n,p,s+q] T[n,p,q]
    # = sum_q B[n, q, s+q] with B = einsum over p: the identical
    # arithmetic at ~60x less compute than stacking D (N, P, P) slices,
    # and nothing written then re-read.
    B = jnp.einsum("nps,npq->nqs", strip, tmpl)                         # (N,P,S)
    cross = sum(B[:, q, q : q + D] for q in range(P))                   # (N,D)
    t_sq = jnp.sum(tmpl * tmpl, axis=(-1, -2))
    ssd_start = win_sq - 2.0 * cross + t_sq[:, None]                    # (N,D) by start
    # start s corresponds to disparity d = D-1-s; flip to index by d.
    ssd = jnp.flip(ssd_start, axis=-1) / (P * P)
    del N
    # Invalidate disparities that push the patch out of the image.
    d_range = jnp.arange(D, dtype=kp_left.dtype)
    valid_d = (u[:, None] - d_range[None, :]) >= (half + 1)
    ssd = jnp.where(valid_d, ssd, jnp.inf)
    best = jnp.argmin(ssd, axis=-1)                                    # (N,)
    best_cost = jnp.take_along_axis(ssd, best[:, None], axis=-1)[:, 0]
    # Sub-pixel parabola fit around the minimum.
    bm1 = jnp.clip(best - 1, 0, D - 1)
    bp1 = jnp.clip(best + 1, 0, D - 1)
    c0 = jnp.take_along_axis(ssd, bm1[:, None], axis=-1)[:, 0]
    c2 = jnp.take_along_axis(ssd, bp1[:, None], axis=-1)[:, 0]
    c1 = best_cost
    denom = c0 - 2 * c1 + c2
    delta = jnp.where(
        (jnp.abs(denom) > 1e-9) & jnp.isfinite(c0) & jnp.isfinite(c2),
        0.5 * (c0 - c2) / jnp.maximum(denom, 1e-9),
        0.0,
    )
    delta = jnp.clip(delta, -1.0, 1.0)
    disparity = best.astype(kp_left.dtype) + delta
    ok = (
        mask
        & jnp.isfinite(best_cost)
        & (best_cost < params.max_cost)
        & (disparity > params.min_disparity)
        & (best > 0)
        & (best < D - 1)
    )
    return disparity, best_cost, ok


def disparity_to_depth(disparity, focal, baseline, ok=None):
    """z = f b / d; masked entries get depth 0."""
    d = jnp.maximum(disparity, 1e-6)
    z = focal * baseline / d
    if ok is not None:
        z = jnp.where(ok, z, 0.0)
    return z
