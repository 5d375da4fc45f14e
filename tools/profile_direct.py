"""Micro-profile INSIDE direct tracking: per-level cost, window
extraction vs the GN loop, and the sampling einsum layout cost.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, n=20):
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
    from viso_tpu.geometry import sampling
    from viso_tpu.ops import direct, pyramid

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
    p = direct.DirectParams()

    # Per-level cost of a full _level_pass.
    for level in range(4):
        intr_l = intr.at_level(level)
        f = jax.jit(lambda a, b, il=intr_l, lv=level: direct._level_pass(
            a, b, pts, mask, R, t, R, t, il, p))
        ms = timeit(lambda: f(pyr0[level], pyr1[level])) * 1e3
        print(f"level {level} ({pyr0[level].shape[0]}x{pyr0[level].shape[1]})"
              f" full pass     : {ms:7.2f} ms")

    # Window extraction alone, level 0 (win=16).
    centers = jnp.asarray(rng.uniform(30, 300, (A, 2)), jnp.float32)
    for win in (16, 24):
        f = jax.jit(lambda c, w=win: sampling.extract_windows(img0, c, w))
        ms = timeit(lambda: f(centers)) * 1e3
        print(f"extract_windows win={win}      : {ms:7.2f} ms")

    # One sample_windows pass (the per-iteration cost), win=16, 8x8 patch.
    wins, base = sampling.extract_windows(img0, centers, 16)
    offs = sampling.patch_offsets(4)
    uv = centers[:, None, None, :] + offs[None]
    f = jax.jit(lambda u: sampling.sample_windows(wins, base, u))
    print(f"sample_windows (1 pass)      : {timeit(lambda: f(uv))*1e3:7.2f} ms")

    f = jax.jit(lambda u: sampling.sample_windows_with_grad(wins, base, u))
    print(f"sample_windows_with_grad     : {timeit(lambda: f(uv))*1e3:7.2f} ms")

    # 10 chained sample passes (isolates the GN-loop sampling cost).
    def chain(u):
        acc = jnp.zeros(())
        for i in range(10):
            acc = acc + sampling.sample_windows(wins, base, u + acc * 1e-9).sum()
        return acc
    f = jax.jit(chain)
    print(f"10x sample_windows chained   : {timeit(lambda: f(uv))*1e3:7.2f} ms")


if __name__ == "__main__":
    main()
