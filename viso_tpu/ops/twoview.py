"""Two-view initialization: motion hypotheses, selection, scale fixing.

JAX replacement for the reference's `PoseEstimation2d2d` +
`SelectMotion` (`/root/reference/src/viso.cpp:178-256, 520-638`):
disparity gate (viso.cpp:197-218), essential + homography hypothesis
generation, per-candidate triangulation with depth / parallax /
reprojection gates (viso.cpp:556-599), best-motion argmax
(viso.cpp:605-620), and mean-depth scene normalization
(viso.cpp:622-637).

The per-candidate x per-correspondence double loop becomes a single
broadcasted triangulation over a (num_candidates, N) grid.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from viso_tpu.geometry import epipolar, triangulation
from viso_tpu.ops import ransac as ransac_mod


class TwoViewResult(NamedTuple):
    R: jnp.ndarray            # (3, 3) world(frame1)->frame2
    t: jnp.ndarray            # (3,)
    points: jnp.ndarray       # (N, 3) triangulated points (frame1 = world)
    inliers: jnp.ndarray      # (N,) bool
    num_inliers: jnp.ndarray  # scalar int
    num_tracks: jnp.ndarray   # scalar int (valid correspondences in)
    disparity_ok: jnp.ndarray  # scalar bool — enough baseline to init
    # Median triangulation parallax (deg) over the selected motion's
    # inliers: a rotation-COMPENSATED baseline measure. The reference's
    # disparity gate (viso.cpp:197-218) reads raw flow, which rotation
    # inflates — on a rotating trajectory it passes with near-zero
    # baseline and the bootstrap triangulates at <1 deg parallax, giving
    # depth noise that destabilizes the whole young segment.
    median_parallax_deg: jnp.ndarray  # scalar f32


class TwoViewParams(NamedTuple):
    focal: float = 520.0               # for pixel-unit gates (ref multiplies by K(0,0))
    projection_error_thresh: float = 0.3   # px, ref viso.h:22
    parallax_thresh_deg: float = 1.0       # ref viso.h:23 (accepts LOW parallax)
    disparity_squared_thresh: float = 15.0**2  # px^2, ref viso.h:24
    ransac_hypotheses: int = 512
    use_homography: bool = True            # ref USE_HOMOGRAPHY viso.cpp:237


def select_motion(x1, x2, mask, Rs, ts, params: TwoViewParams):
    """Score candidate motions by gated triangulation inlier count.

    x1, x2: (N, 2) normalized coords; Rs (C, 3, 3), ts (C, 3).
    Exactly the gates of viso.cpp:556-599. Returns
    (best_R, best_t, points (N,3), inliers (N,), num_inliers).
    """
    C = Rs.shape[0]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=x1.dtype), (C, 3, 3))
    zero = jnp.zeros((C, 3), dtype=x1.dtype)
    # Broadcast triangulation over candidates x correspondences.
    Xw, d1, d2 = triangulation.triangulate(
        x1[None], x2[None], eye[:, None], zero[:, None], Rs[:, None], ts[:, None]
    )  # (C, N, 3), (C, N), (C, N)

    # Gate 1: cheirality in both views (viso.cpp:557,587).
    good = (d1 > 0) & (d2 > 0)
    # Gate 2: parallax angle <= thresh degrees (viso.cpp:561-571 rejects
    # parallax > 1 deg — the reference accepts low-parallax points).
    cosang = triangulation.parallax_cos(
        Xw, eye[:, None], zero[:, None], Rs[:, None], ts[:, None]
    )
    cos_thresh = jnp.cos(jnp.deg2rad(params.parallax_thresh_deg))
    good &= cosang >= cos_thresh
    # Gate 3: reprojection error <= thresh px in both views (viso.cpp:574-599).
    e1 = triangulation.reprojection_error(Xw, x1[None], eye[:, None], zero[:, None])
    e2 = triangulation.reprojection_error(Xw, x2[None], Rs[:, None], ts[:, None])
    px = params.focal
    good &= (e1 * px <= params.projection_error_thresh) & (
        e2 * px <= params.projection_error_thresh
    )
    good &= mask[None, :]

    counts = jnp.sum(good, axis=-1)
    best = jnp.argmax(counts)
    R, t = Rs[best], ts[best]
    inl = good[best]
    pts = Xw[best]
    # Mean-depth normalization (viso.cpp:622-637): scale scene + t so the
    # mean inlier depth is 1 — the monocular scale fix.
    depths = pts[:, 2]  # frame1 is the world frame here
    mean_depth = jnp.sum(jnp.where(inl, depths, 0.0)) / jnp.maximum(
        jnp.sum(inl), 1
    )
    scale = jnp.where(mean_depth > 1e-9, 1.0 / mean_depth, 1.0)
    # Median inlier parallax of the WINNING motion (deg): the caller's
    # rotation-compensated accept gate.
    ang = jnp.rad2deg(jnp.arccos(jnp.clip(cosang[best], -1.0, 1.0)))
    med_par = jnp.nanmedian(jnp.where(inl, ang, jnp.nan))
    med_par = jnp.where(jnp.isfinite(med_par), med_par, 0.0)
    return R, t * scale, pts * scale, inl, counts[best], med_par


@partial(jax.jit, static_argnames=("params",))
def initialize(key, x1, x2, mask, params: TwoViewParams = TwoViewParams()):
    """Full two-view initialization on normalized correspondences.

    Mirrors PoseEstimation2d2d (viso.cpp:178-256): disparity gate, E-RANSAC
    (+ optional homography hypotheses), candidate decomposition, gated
    motion selection, scale normalization.
    """
    n_tracks = jnp.sum(mask)
    # Disparity gate: mean squared pixel disparity >= thresh (viso.cpp:197-218).
    disp_sq = jnp.sum((x1 - x2) ** 2, axis=-1) * params.focal**2
    mean_disp = jnp.sum(jnp.where(mask, disp_sq, 0.0)) / jnp.maximum(n_tracks, 1)
    disparity_ok = mean_disp >= params.disparity_squared_thresh

    # Sampson threshold in normalized units ~ (thresh_px / f)^2.
    sampson_thresh = (params.projection_error_thresh / params.focal) ** 2 * 4.0
    k_e, k_h = jax.random.split(key)
    e_res = ransac_mod.essential_ransac(
        k_e, x1, x2, mask,
        threshold=sampson_thresh,
        num_hypotheses=params.ransac_hypotheses,
    )
    Rs_e, ts_e = epipolar.decompose_essential(e_res.model)  # (4,3,3), (4,3)
    if params.use_homography:
        h_res = ransac_mod.homography_ransac(
            k_h, x1, x2, mask,
            threshold=sampson_thresh,
            num_hypotheses=params.ransac_hypotheses // 2,
        )
        Rs_h, ts_h, _ = epipolar.decompose_homography(h_res.model)
        Rs = jnp.concatenate([Rs_e, Rs_h], axis=0)
        ts = jnp.concatenate([ts_e, ts_h], axis=0)
    else:
        Rs, ts = Rs_e, ts_e

    R, t, pts, inl, n_inl, med_par = select_motion(x1, x2, mask, Rs, ts, params)
    return TwoViewResult(
        R, t, pts, inl, n_inl, n_tracks, disparity_ok, med_par
    )
