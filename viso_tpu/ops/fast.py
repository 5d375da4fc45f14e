"""FAST corner detection, fully vectorized.

JAX replacement for `cv::FAST` used by the reference's init
re-seeding (`/root/reference/src/viso.cpp:100-108`, threshold 50,
`include/viso.h:21` fast_thresh). Instead of a per-pixel scalar test we
evaluate the segment test densely on the whole image with 16 shifted
copies (elementwise ops), score every pixel, 3x3 non-max suppress
with a reduce_window, and extract a *fixed-size* keypoint set with
`top_k` + validity mask — static shapes for everything downstream.

A grid-bucketed variant (`detect_grid`) spreads detections evenly across
the image, which markedly improves RANSAC conditioning on real data.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# 5-tap binomial [1,4,6,4,1]/16 (sigma ~1): detection pre-smoothing.
# FAST scores on a noisy image are near-ties whose per-cell top-k ranks
# reshuffle with every independent noise draw — measured keypoint
# repeatability under sigma=3 sensor noise was 11-14% (loop-closure
# matching needs the SAME physical corners re-detected on revisit; a
# revisit's descriptor matches tripled, 38 -> 84, with this smoothing).
# One fused elementwise pass; corner localization shift is sub-pixel.
_BINOMIAL5 = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def smooth_binomial(img):
    """One separable 5-tap binomial pass (sigma ~1.03)."""
    xp = jnp.pad(img, ((2, 2), (0, 0)), mode="edge")
    img = sum(_BINOMIAL5[k] * xp[k: k + img.shape[0]] for k in range(5))
    xp = jnp.pad(img, ((0, 0), (2, 2)), mode="edge")
    return sum(_BINOMIAL5[k] * xp[:, k: k + img.shape[1]] for k in range(5))


# Bresenham circle of radius 3 as (drow, dcol), clockwise (FAST-9/16).
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
_ARC = 9  # FAST-9 contiguity


def _shifted_stack(img):
    """(16, H, W) copies of img shifted so index i holds circle-pixel i.

    Built from static slices of a zero-padded image (not jnp.roll: rolls
    materialize full-size shuffled copies; padded slices fuse).
    """
    H, W = img.shape
    padded = jnp.pad(img, 3)
    return jnp.stack(
        [
            lax.slice(padded, (3 + dr, 3 + dc), (3 + dr + H, 3 + dc + W))
            for dr, dc in _CIRCLE
        ],
        axis=0,
    )


def score_map(img, threshold: float):
    """Dense FAST-9 corner score (H, W); 0 where the segment test fails.

    Score = max(sum of brighter-arc excesses, sum of darker-arc excesses),
    the usual OpenCV-style corner response family.

    The padded-slice formulation below fuses into one elementwise pass
    under XLA (no materialized shifted copies). A hand-written Pallas
    variant (VMEM-resident, roll- and halo-slice-based) was tried in
    rounds 1-2 and removed: Mosaic hangs >7 min compiling the 16-way
    segment test at KITTI frame sizes on this toolchain, and the fused
    XLA form is already memory-bound (one read, one write).
    """
    img = smooth_binomial(jnp.asarray(img, dtype=jnp.float32))
    circ = _shifted_stack(img)
    diff = circ - img[None]
    brighter = diff > threshold
    darker = diff < -threshold
    # Contiguous arcs of length >= 9 on the 16-cycle, via a binary-tree
    # running AND: and2[s] = x[s] & x[s+1], and4 = and2[s] & and2[s+2],
    # and8 = and4[s] & and4[s+4], arc9[s] = and8[s] & x[s+8]. 4 passes
    # of 16 elementwise ANDs instead of 16 windows x 9 reads each
    # (2.5x fewer full-image passes on the segment test — the corner
    # detector is pure HBM bandwidth).
    def arc9_any(x):
        x2 = jnp.concatenate([x, x[:8]], axis=0)        # cyclic pad
        a2 = x2[:-1] & x2[1:]                           # (23,H,W) len-2
        a4 = a2[:-2] & a2[2:]                           # (21,H,W) len-4
        a8 = a4[:-4] & a4[4:]                           # (17,H,W) len-8
        a9 = a8[:16] & x2[8:]                           # (16,H,W) len-9
        return jnp.any(a9, axis=0)

    is_corner_b = arc9_any(brighter)
    is_corner_d = arc9_any(darker)
    v_b = jnp.sum(jnp.where(brighter, diff - threshold, 0.0), axis=0)
    v_d = jnp.sum(jnp.where(darker, -diff - threshold, 0.0), axis=0)
    score = jnp.maximum(
        jnp.where(is_corner_b, v_b, 0.0), jnp.where(is_corner_d, v_d, 0.0)
    )
    # Kill the 3-pixel border (ring samples are padding-contaminated there).
    H, W = img.shape
    rows = jnp.arange(H)[:, None]
    cols = jnp.arange(W)[None, :]
    valid = (rows >= 3) & (rows < H - 3) & (cols >= 3) & (cols < W - 3)
    return jnp.where(valid, score, 0.0)


def _nms(score):
    pooled = lax.reduce_window(
        score, -jnp.inf, lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= pooled, score, 0.0)


def detect(img, threshold: float = 50.0, max_num: int = 1024, nms: bool = True):
    """FAST corners -> (uv (max_num, 2) float32, score (max_num,), mask (max_num,)).

    uv is (u=col, v=row) to match the reference's keypoint convention.
    Invalid slots (beyond the number of detections) have mask=False.
    """
    s = score_map(img, threshold)
    if nms:
        s = _nms(s)
    H, W = s.shape
    vals, idx = lax.top_k(s.reshape(-1), max_num)
    v = (idx // W).astype(jnp.float32)
    u = (idx % W).astype(jnp.float32)
    uv = jnp.stack([u, v], axis=-1)
    mask = vals > 0.0
    return uv, vals, mask


def detect_grid_pyramid(
    pyr,
    threshold: float = 25.0,
    grid: tuple[int, int] = (8, 8),
    per_cell: int = 16,
    levels: int = 3,
    threshold_decay: float = 2.0,
):
    """Multi-scale grid-bucketed FAST over an image pyramid.

    Close-range / defocused surfaces magnify texture until level-0 FAST
    finds nothing (measured on the orbit bench: 0 corners at level 0
    where level 2 at threshold/4 has 150+), which starves tracking and
    turns entire sectors into dead reckoning. Detection therefore runs
    on `levels` pyramid levels with per-level threshold
    `threshold / threshold_decay**level` and coordinates mapped to
    level 0; each grid cell keeps its finest-level corners first
    (best localization) and fills the remaining budget from coarser
    levels. Output shape matches detect_grid: (G*per_cell, 2) uv at
    level-0 coords, score, mask.

    The reference's cv::FAST call (viso.cpp:100-108) is single-scale;
    multi-scale detection generalizes it the way ORB-style pyramidal
    detectors do, and is what makes the close-wall sectors of the loop
    benchmark trackable at all.
    """
    levels = min(levels, len(pyr))
    H, W = pyr[0].shape
    gh, gw = grid
    all_uv, all_key, all_score = [], [], []
    for lvl in range(levels):
        thr = threshold / (threshold_decay**lvl)
        s = score_map(pyr[lvl], thr)
        s = _nms(s)
        Hl, Wl = s.shape
        if Hl < gh or Wl < gw:
            # Level smaller than the grid (tiny image / deep pyramid):
            # no room for one pixel per cell — stop descending.
            break
        ch, cw = max(1, Hl // gh), max(1, Wl // gw)
        s_c = s[: gh * ch, : gw * cw].reshape(gh, ch, gw, cw)
        s_c = jnp.moveaxis(s_c, 2, 1).reshape(gh * gw, ch * cw)
        k = min(per_cell, ch * cw)
        vals, idx = lax.top_k(s_c, k)                      # (G, k)
        cell_ids = jnp.arange(gh * gw)
        cell_r = (cell_ids // gw) * ch
        cell_c = (cell_ids % gw) * cw
        r = cell_r[:, None] + idx // cw
        c = cell_c[:, None] + idx % cw
        scale = float(2**lvl)
        # Pixel-center-aligned mapping of level-l coords to level 0.
        u0 = (c.astype(jnp.float32) + 0.5) * scale - 0.5
        v0 = (r.astype(jnp.float32) + 0.5) * scale - 0.5
        if k < per_cell:
            pad = per_cell - k
            u0 = jnp.pad(u0, ((0, 0), (0, pad)))
            v0 = jnp.pad(v0, ((0, 0), (0, pad)))
            vals = jnp.pad(vals, ((0, 0), (0, pad)))
        # Sort key: finer level ALWAYS beats coarser; score breaks ties
        # within a level. Scores are bounded by 16*255 < 5e3 << 1e6.
        key = jnp.where(vals > 0.0, (levels - lvl) * 1.0e6 + vals, -jnp.inf)
        all_uv.append(jnp.stack([u0, v0], axis=-1))        # (G, per_cell, 2)
        all_key.append(key)
        all_score.append(vals)
    if not all_uv:
        raise ValueError(
            f"image {pyr[0].shape} smaller than detection grid {grid}"
        )
    uv = jnp.concatenate(all_uv, axis=1)                   # (G, levels*pc, 2)
    key = jnp.concatenate(all_key, axis=1)
    score = jnp.concatenate(all_score, axis=1)
    topk, sel = lax.top_k(key, per_cell)                   # (G, per_cell)
    uv = jnp.take_along_axis(uv, sel[:, :, None], axis=1).reshape(-1, 2)
    score = jnp.take_along_axis(score, sel, axis=1).reshape(-1)
    mask = jnp.isfinite(topk).reshape(-1)
    # Masked slots: pin coords to a safe in-bounds location (0 scores).
    uv = jnp.where(mask[:, None], uv, jnp.zeros_like(uv))
    return uv, jnp.where(mask, score, 0.0), mask


def detect_grid(
    img,
    threshold: float = 25.0,
    grid: tuple[int, int] = (8, 8),
    per_cell: int = 16,
):
    """Grid-bucketed FAST: top `per_cell` corners in each grid cell.

    Returns (uv (G*per_cell, 2), score, mask) with G = grid[0]*grid[1].
    Static output size; empty cells yield masked-out slots.
    """
    s = score_map(img, threshold)
    s = _nms(s)
    H, W = s.shape
    gh, gw = grid
    ch, cw = H // gh, W // gw
    s_c = s[: gh * ch, : gw * cw].reshape(gh, ch, gw, cw)
    s_c = jnp.moveaxis(s_c, 2, 1).reshape(gh * gw, ch * cw)
    vals, idx = lax.top_k(s_c, per_cell)  # (G, per_cell)
    cell_ids = jnp.arange(gh * gw)
    cell_r = (cell_ids // gw) * ch
    cell_c = (cell_ids % gw) * cw
    r = cell_r[:, None] + idx // cw
    c = cell_c[:, None] + idx % cw
    uv = jnp.stack([c.astype(jnp.float32), r.astype(jnp.float32)], axis=-1)
    uv = uv.reshape(-1, 2)
    vals = vals.reshape(-1)
    return uv, vals, vals > 0.0
