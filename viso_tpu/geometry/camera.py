"""Pinhole camera model with pyramid-level scaling.

JAX replacement for the reference's `Keyframe::Project`
(`/root/reference/include/keyframe.h:82-89` — pinhole projection with
per-level intrinsic scaling by 0.5**level), `IsInside`
(`keyframe.h:71-80`), and `ViewingAngle` (`keyframe.h:93-98`).

Intrinsics are carried as a flat vector ``(fx, fy, cx, cy)`` so they
broadcast trivially and stay SMEM-friendly inside kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Intrinsics(NamedTuple):
    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray

    @classmethod
    def create(cls, fx, fy, cx, cy, dtype=jnp.float32):
        return cls(*(jnp.asarray(v, dtype=dtype) for v in (fx, fy, cx, cy)))

    def matrix(self):
        """3x3 K matrix (ref viso.h:47-52 builds K, K_inv in the ctor)."""
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx], axis=-1),
                jnp.stack([z, self.fy, self.cy], axis=-1),
                jnp.stack([z, z, o], axis=-1),
            ],
            axis=-2,
        )

    def at_level(self, level):
        """Intrinsics at pyramid `level` (scale 0.5**level, ref keyframe.h:84)."""
        s = jnp.asarray(0.5, dtype=jnp.result_type(self.fx)) ** level
        # The pyramid halving maps pixel centers as u' = (u + 0.5)/2 - 0.5,
        # i.e. cx' = (cx + 0.5) * s - 0.5 — keeps sub-pixel alignment across
        # levels (the reference's plain cx*s is half-pixel biased).
        return Intrinsics(
            self.fx * s, self.fy * s, (self.cx + 0.5) * s - 0.5, (self.cy + 0.5) * s - 0.5
        )

    def scaled(self, s):
        return Intrinsics(self.fx * s, self.fy * s, (self.cx + 0.5) * s - 0.5, (self.cy + 0.5) * s - 0.5)


def project(points_cam, intr: Intrinsics, eps: float = 1e-6):
    """Camera-frame points (..., 3) -> pixel coords (..., 2) + depth (...,).

    Returns (uv, depth). Callers gate on depth > 0 themselves (the
    reference asserts positive depth at keyframe.h:85).
    """
    z = points_cam[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < eps, jnp.where(z < 0, -eps, eps), z)
    u = intr.fx * points_cam[..., 0] * inv_z + intr.cx
    v = intr.fy * points_cam[..., 1] * inv_z + intr.cy
    return jnp.stack([u, v], axis=-1), z


def backproject(uv, depth, intr: Intrinsics):
    """Pixel coords (..., 2) + depth (...,) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - intr.cx) / intr.fx
    y = (uv[..., 1] - intr.cy) / intr.fy
    return jnp.stack([x * depth, y * depth, depth], axis=-1)


def normalize(uv, intr: Intrinsics):
    """Pixels -> normalized image coords p = K^-1 [u v 1] (ref viso.cpp:46-47)."""
    x = (uv[..., 0] - intr.cx) / intr.fx
    y = (uv[..., 1] - intr.cy) / intr.fy
    return jnp.stack([x, y], axis=-1)


def denormalize(xy, intr: Intrinsics):
    u = xy[..., 0] * intr.fx + intr.cx
    v = xy[..., 1] * intr.fy + intr.cy
    return jnp.stack([u, v], axis=-1)


def is_inside(uv, height, width, border: float = 0.0):
    """Bounds mask (ref keyframe.h:71-80 IsInside with patch border)."""
    u, v = uv[..., 0], uv[..., 1]
    return (
        (u >= border)
        & (u < width - 1 - border)
        & (v >= border)
        & (v < height - 1 - border)
    )


def viewing_cos(points_cam):
    """cos(angle between optical axis and the ray) (ref keyframe.h:93-98).

    Larger is better (ray closer to the optical axis). Works on
    camera-frame points (..., 3).
    """
    norm = jnp.linalg.norm(points_cam, axis=-1)
    return points_cam[..., 2] / (norm + 1e-9)
