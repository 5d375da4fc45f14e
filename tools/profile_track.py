"""Micro-profile of the track super-kernel's sub-stages on the device:
pyramid, direct (per level count), alignment, PnP refine. Identifies the
compute hot spot inside the per-frame path.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, n=10):
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    from viso_tpu.utils import compile_cache

    compile_cache.enable()
    from viso_tpu.geometry import camera as cam_mod
    from viso_tpu.ops import align, direct, pnp, pyramid

    H, W = 376, 1240
    A = 1024
    intr = cam_mod.Intrinsics.create(718.856, 718.856, 607.1928, 185.2157)
    rng = np.random.default_rng(0)
    img0 = jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32)
    img1 = jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32)
    pyr0 = pyramid.build_pyramid(img0)
    pyr1 = pyramid.build_pyramid(img1)
    pts = jnp.asarray(np.stack([
        rng.uniform(-5, 5, A), rng.uniform(-2, 2, A), rng.uniform(5, 40, A)
    ], -1), jnp.float32)
    mask = jnp.ones(A, bool)
    R = jnp.eye(3, dtype=jnp.float32)
    t = jnp.zeros(3, jnp.float32)

    bp = jax.jit(lambda im: pyramid.build_pyramid(im))
    print(f"pyramid            : {timeit(lambda: bp(img1))*1e3:7.2f} ms")

    for lv in (4, 3):
        p = direct.DirectParams(levels=lv)
        f = jax.jit(lambda a, b: direct.estimate_pose(
            a, b, R, t, pts, mask, intr, R, t, p))
        print(f"direct levels={lv}    : {timeit(lambda: f(pyr0, pyr1))*1e3:7.2f} ms")

    # Alignment: stack of K keyframe pyramids.
    K = 8
    kf_pyr = tuple(jnp.broadcast_to(l[None], (K,) + l.shape) for l in pyr0)
    k_idx = jnp.zeros(A, jnp.int32)
    uv_ref = jnp.asarray(rng.uniform(20, 350, (A, 2)), jnp.float32)
    uv_pred = uv_ref + 1.0
    f_al = jax.jit(lambda kp, c: align.align(kp, k_idx, uv_ref, c, uv_pred, mask))
    print(f"align              : {timeit(lambda: f_al(kf_pyr, pyr1))*1e3:7.2f} ms")

    x_ref = cam_mod.normalize(uv_ref, intr)
    f_pnp = jax.jit(lambda: pnp.refine_pose(
        R, t, pts, x_ref, mask.astype(jnp.float32), huber=0.003, iters=8))
    print(f"pnp refine         : {timeit(f_pnp)*1e3:7.2f} ms")


if __name__ == "__main__":
    main()
