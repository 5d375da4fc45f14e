"""Batched two-view triangulation.

JAX replacement for the reference's Hartley-Sturm style DLT
(`/root/reference/src/viso.cpp:393-431` — a 4x4 homogeneous system per
point solved by `JacobiSVD`). A per-point 4x4 SVD batches poorly and,
in float32, the squared conditioning of the homogeneous system costs
real accuracy. We instead solve the two-ray depth system directly:

    d2 * f2 = R21 (d1 * f1) + t21

which is a 3-equation / 2-unknown least-squares problem with a closed
form 2x2 solution — exact on noise-free data, well-conditioned, no
decomposition at all, and it is a handful of fused elementwise ops.
The returned point is the midpoint of the two rays'
closest approach (the classic midpoint triangulator).
"""

from __future__ import annotations

import jax.numpy as jnp


def triangulate(x1, x2, R1, t1, R2, t2):
    """Triangulate correspondences seen in two cameras.

    x1, x2: (..., 2) *normalized* image coordinates (K^-1 applied), matching
      the reference which triangulates normalized points (viso.cpp:46-48).
    (R1, t1), (R2, t2): world->camera poses of the two views; poses
      broadcast against the correspondence batch.

    Returns (points_world (..., 3), depth1 (...,), depth2 (...,)).
    Negative depths signal cheirality failures (ref viso.cpp:557-559).
    """
    ones = jnp.ones_like(x1[..., :1])
    f1 = jnp.concatenate([x1, ones], axis=-1)  # ray in cam1
    f2 = jnp.concatenate([x2, ones], axis=-1)  # ray in cam2
    # Relative transform cam1 -> cam2.
    R21 = R2 @ jnp.swapaxes(R1, -1, -2)
    t21 = t2 - jnp.einsum("...ij,...j->...i", R21, t1)
    a = jnp.einsum("...ij,...j->...i", R21, f1)  # direction of ray 1 in cam2
    # Least squares for [d1, d2] in  d1 * a - d2 * f2 = -t21.
    aa = jnp.sum(a * a, axis=-1)
    ab = jnp.sum(a * f2, axis=-1)
    bb = jnp.sum(f2 * f2, axis=-1)
    at = jnp.sum(a * t21, axis=-1)
    bt = jnp.sum(f2 * t21, axis=-1)
    det = aa * bb - ab * ab
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    d1 = (ab * bt - bb * at) / det
    d2 = (aa * bt - ab * at) / det
    # Midpoint of the two closest ray points, expressed in cam2 then world.
    p_from1 = d1[..., None] * a + t21
    p_from2 = d2[..., None] * f2
    mid_c2 = 0.5 * (p_from1 + p_from2)
    Xw = jnp.einsum("...ji,...j->...i", R2, mid_c2 - t2)
    return Xw, d1, d2


def reprojection_error(Xw, x, R, t):
    """Normalized-coordinate reprojection error (...,) for points (..., 3).

    The reference gates on this at 0.3/f px (viso.cpp:574-599).
    """
    pc = jnp.einsum("...ij,...j->...i", R, Xw) + t
    z = pc[..., 2]
    proj = pc[..., :2] / (z[..., None] + jnp.where(z[..., None] >= 0, 1e-12, -1e-12))
    return jnp.linalg.norm(proj - x, axis=-1)


def parallax_cos(Xw, R1, t1, R2, t2):
    """cos of the angle between the two viewing rays (ref viso.cpp:561-571).

    cos close to 1 = low parallax (bad for triangulation).
    """
    c1 = -jnp.einsum("...ji,...j->...i", R1, t1)  # camera centers in world
    c2 = -jnp.einsum("...ji,...j->...i", R2, t2)
    r1 = Xw - c1
    r2 = Xw - c2
    num = jnp.sum(r1 * r2, axis=-1)
    den = jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1) + 1e-12
    return num / den
