"""Fixed-capacity structure-of-arrays map (keyframes + landmarks + obs).

JAX replacement for the reference's pointer-based map
(`/root/reference/include/map.h` — std::vectors of heap Keyframe/MapPoint
objects, `include/map_point.h` — per-point observation lists). XLA needs
static shapes, so:

  * Keyframes live in `K` fixed slots (round-robin sliding window —
    realizing the intent of the reference's unused `RingBuffer`,
    `include/ring_buffer.h:10-42`).
  * Landmarks live in `L` fixed slots with a validity mask.
  * Observations are a dense (K, L) masked grid — uv + mask — which is
    exactly the layout backend/ba.py consumes, so window BA is zero-copy.
  * Keyframe image pyramids are stacked per level: tuple of (K, h_l, w_l),
    giving ops/align.py flat indexed gathers.

All mutation functions are pure (return a new MapState) and jit-able.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class MapState(NamedTuple):
    kf_R: jnp.ndarray        # (K, 3, 3) world->cam
    kf_t: jnp.ndarray        # (K, 3)
    kf_mask: jnp.ndarray     # (K,) slot in use
    kf_frame_id: jnp.ndarray  # (K,) int32 source frame index
    kf_pyr: tuple            # per level: (K, h_l, w_l) float32
    points: jnp.ndarray      # (L, 3) world
    point_mask: jnp.ndarray  # (L,)
    obs_uv: jnp.ndarray      # (K, L, 2) pixel coords at level 0
    obs_mask: jnp.ndarray    # (K, L)

    @property
    def num_keyframes(self):
        return jnp.sum(self.kf_mask)

    @property
    def num_points(self):
        return jnp.sum(self.point_mask)


def empty(K: int, L: int, img_shape, num_levels: int = 4) -> MapState:
    H, W = img_shape
    pyr = tuple(
        jnp.zeros((K, H // 2**lvl, W // 2**lvl), jnp.float32)
        for lvl in range(num_levels)
    )
    return MapState(
        kf_R=jnp.tile(jnp.eye(3, dtype=jnp.float32), (K, 1, 1)),
        kf_t=jnp.zeros((K, 3), jnp.float32),
        kf_mask=jnp.zeros(K, bool),
        kf_frame_id=jnp.full(K, -1, jnp.int32),
        kf_pyr=pyr,
        points=jnp.zeros((L, 3), jnp.float32),
        point_mask=jnp.zeros(L, bool),
        obs_uv=jnp.zeros((K, L, 2), jnp.float32),
        obs_mask=jnp.zeros((K, L), bool),
    )


def insert_keyframe(m: MapState, slot, R, t, frame_id, pyramid) -> MapState:
    """Place a keyframe in `slot`, clearing that slot's observations."""
    pyr = tuple(
        lvl_stack.at[slot].set(lvl) for lvl_stack, lvl in zip(m.kf_pyr, pyramid)
    )
    return m._replace(
        kf_R=m.kf_R.at[slot].set(R),
        kf_t=m.kf_t.at[slot].set(t),
        kf_mask=m.kf_mask.at[slot].set(True),
        kf_frame_id=m.kf_frame_id.at[slot].set(frame_id),
        kf_pyr=pyr,
        obs_uv=m.obs_uv.at[slot].set(0.0),
        obs_mask=m.obs_mask.at[slot].set(False),
    )


def evict_keyframe(m: MapState, slot) -> MapState:
    """Free a keyframe slot and drop its observations; landmarks that lose
    their last observation are freed too."""
    obs_mask = m.obs_mask.at[slot].set(False)
    point_mask = m.point_mask & jnp.any(obs_mask, axis=0)
    return m._replace(
        kf_mask=m.kf_mask.at[slot].set(False),
        kf_frame_id=m.kf_frame_id.at[slot].set(-1),
        obs_mask=obs_mask,
        point_mask=point_mask,
    )


def set_observations(m: MapState, kf_slot, lm_idx, uv, valid) -> MapState:
    """Write observations of landmarks `lm_idx` (M,) in keyframe `kf_slot`."""
    obs_uv = m.obs_uv.at[kf_slot, lm_idx].set(
        jnp.where(valid[:, None], uv, m.obs_uv[kf_slot, lm_idx])
    )
    obs_mask = m.obs_mask.at[kf_slot, lm_idx].set(
        m.obs_mask[kf_slot, lm_idx] | valid
    )
    return m._replace(obs_uv=obs_uv, obs_mask=obs_mask)


def allocate_landmarks(m: MapState, pts, valid):
    """Allocate slots for up to M new landmarks.

    pts (M, 3), valid (M,). Returns (MapState, slots (M,), ok (M,)) where
    ok additionally excludes allocations that didn't fit in free capacity.
    Free slots are taken in index order (argsort of the bool mask puts
    False first, stably).
    """
    M = pts.shape[0]
    order = jnp.argsort(m.point_mask)  # free slots first
    slots = order[:M]
    slot_is_free = ~m.point_mask[slots]
    ok = valid & slot_is_free
    points = m.points.at[slots].set(jnp.where(ok[:, None], pts, m.points[slots]))
    point_mask = m.point_mask.at[slots].set(m.point_mask[slots] | ok)
    return m._replace(points=points, point_mask=point_mask), slots, ok


def update_from_ba(m: MapState, R, t, points) -> MapState:
    """Write back BA-optimized poses/points (masked slots untouched)."""
    return m._replace(
        kf_R=jnp.where(m.kf_mask[:, None, None], R, m.kf_R),
        kf_t=jnp.where(m.kf_mask[:, None], t, m.kf_t),
        points=jnp.where(m.point_mask[:, None], points, m.points),
    )


def as_photo_ba_problem(m: MapState, intr, level: int = 1, half_patch: int = 2):
    """View the window as a backend/ba_photometric.PhotoBAProblem.

    Realizes the reference's intended photometric backend
    (bundle_adjuster.h:58-106) on live map state: each landmark's 4x4
    template is sampled from its ANCHOR keyframe — the oldest keyframe
    observing it — at the *recorded observation* pixel (not the current
    point projection, so a drifted point estimate cannot corrupt its own
    template). `level` selects the pyramid level the residuals run on.

    Returns (PhotoBAProblem, level_intrinsics).
    """
    from viso_tpu.backend import ba_photometric as pba
    from viso_tpu.geometry import sampling

    images = m.kf_pyr[level]
    intr_l = intr.at_level(level)
    scale = 0.5**level
    # Anchor = observing keyframe with the smallest source frame id
    # (slots are round-robin, so slot order is not age order).
    BIG = jnp.int32(2**30)
    age = jnp.where(m.obs_mask, m.kf_frame_id[:, None], BIG)  # (K, L)
    anchor_idx = jnp.argmin(age, axis=0)                       # (L,)
    uv_anchor = (
        m.obs_uv[anchor_idx, jnp.arange(m.points.shape[0])] * scale
    )
    offs = sampling.patch_offsets(half_patch, uv_anchor.dtype).reshape(-1, 2)
    template = sampling.bilinear_indexed(
        images, anchor_idx, uv_anchor[:, None, :] + offs[None]
    )
    prob = pba.PhotoBAProblem(
        R=m.kf_R,
        t=m.kf_t,
        points=m.points,
        images=images,
        template=template,
        anchor_idx=anchor_idx,
        obs_mask=m.obs_mask,
        cam_mask=m.kf_mask,
        point_mask=m.point_mask,
    )
    return prob, intr_l


def as_ba_problem(m: MapState, intr):
    """View the window as a backend/ba.BAProblem (normalized obs coords)."""
    from viso_tpu.backend import ba
    from viso_tpu.geometry import camera as cam_mod

    x = cam_mod.normalize(m.obs_uv, intr)
    return ba.BAProblem(
        R=m.kf_R,
        t=m.kf_t,
        points=m.points,
        obs_uv=x,
        obs_mask=m.obs_mask,
        cam_mask=m.kf_mask,
        point_mask=m.point_mask,
    )
