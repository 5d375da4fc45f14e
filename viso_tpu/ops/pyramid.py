"""On-device image pyramid construction.

JAX replacement for the reference's `cv::pyrDown` pyramid built in
the `Keyframe` ctor (`/root/reference/include/keyframe.h:20-22,38-45` —
4 levels at scale 0.5). `cv::pyrDown` is a 5x5 Gaussian blur followed by
2x subsampling; we implement the same [1 4 6 4 1]/16 separable kernel as
shift-and-add slices (5 scaled adds per axis) with edge replication at
the borders — pure elementwise work that XLA fuses, where a
single-channel conv_general_dilated would go through the conv emitter.

Pyramids are tuples of (H/2^l, W/2^l) float32 arrays — a static pytree,
so downstream jits trace once per image geometry.
"""

from __future__ import annotations

import jax.numpy as jnp

_KERNEL_1D = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=jnp.float32) / 16.0

NUM_LEVELS = 4  # ref keyframe.h:20-22
SCALES = tuple(0.5**l for l in range(NUM_LEVELS))  # ref viso.cpp:362-364 {1,.5,.25,.125}


def _blur_down(img):
    """5-tap Gaussian blur + 2x subsample of (H, W) image."""
    h, w = img.shape
    k = _KERNEL_1D.astype(img.dtype)
    xp = jnp.pad(img, ((2, 2), (0, 0)), mode="edge")
    v = sum(k[i] * xp[i : i + h, :] for i in range(5))
    v = v[::2]
    vp = jnp.pad(v, ((0, 0), (2, 2)), mode="edge")
    o = sum(k[i] * vp[:, i : i + w] for i in range(5))
    return o[:, ::2]


def build_pyramid(img, num_levels: int = NUM_LEVELS):
    """img (H, W) float -> tuple of `num_levels` images, level 0 = full res."""
    img = jnp.asarray(img, dtype=jnp.float32)
    levels = [img]
    for _ in range(num_levels - 1):
        levels.append(_blur_down(levels[-1]))
    return tuple(levels)
