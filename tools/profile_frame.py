"""Per-stage wall-clock profile of the stereo VO frame path on the
attached device. Prints a table: track kernel, keyframe-insert kernel,
window BA, host sync latency — so we know whether frame time is compute
or dispatch/readback bound.
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
    fn()  # warm
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    from viso_tpu.utils import compile_cache

    compile_cache.enable()
    from viso_tpu.data import synthetic
    from viso_tpu.slam.engine import StereoVO, VOConfig

    H, W = 376, 1240
    cfg = VOConfig(
        height=H, width=W, fx=718.856, fy=718.856, cx=607.1928,
        cy=185.2157, baseline=0.537, num_features=512, max_landmarks=2048,
        detect_grid=(6, 12), fast_threshold=20.0, max_disparity=128,
    )
    intr = cfg.intrinsics()
    rng = np.random.default_rng(42)
    scene = synthetic.corridor_scene(rng, tex_size=1024, far_z=60.0)
    Rs, ts = synthetic.forward_trajectory(16, step=0.8, yaw_rate=0.003)
    frames = []
    for R, t in zip(Rs, ts):
        il, ir, _ = synthetic.make_stereo_pair(scene, intr, R, t, H, W,
                                               baseline=cfg.baseline)
        frames.append((il, ir))

    vo = StereoVO(cfg)
    for il, ir in frames[:10]:
        vo.process(il, ir)

    dev = jax.devices()[0]
    print(f"device: {dev}")

    # 1. Pure round-trip latency: tiny jit + readback.
    tiny = jax.jit(lambda x: x + 1)
    x = jnp.zeros(())
    tiny(x)
    t = timeit(lambda: tiny(x).block_until_ready(), 50)
    print(f"tiny dispatch+sync      : {t*1e3:8.2f} ms")

    # 2. Host->device upload of one uint8 stereo pair.
    il, ir = frames[0]
    il8 = np.clip(il, 0, 255).astype(np.uint8)
    t = timeit(lambda: jax.block_until_ready(jnp.asarray(il8)), 20)
    print(f"upload 1 uint8 image    : {t*1e3:8.2f} ms")

    # 3. Track kernel alone (against the frozen keyframe templates).
    img_dev = jnp.asarray(il8)
    kern = vo._kernels["track"]
    args = (vo.map, vo._templates, vo._active_idx, img_dev, vo.R, vo.t,
            vo.vel_xi)
    t = timeit(lambda: jax.block_until_ready(kern(*args)), 10)
    print(f"track kernel            : {t*1e3:8.2f} ms")

    # 3b. Template build (once per keyframe, off the per-frame path).
    tk = vo._kernels.get("templates")
    if tk is not None:
        slot = vo.kf_order[-1]
        t = timeit(lambda: jax.block_until_ready(tk(vo.map, slot)), 5)
        print(f"template build kernel   : {t*1e3:8.2f} ms")

    # 4. Stereo keyframe insert kernel.
    kf = vo._kernels.get("stereo_kf")
    if kf is not None:
        ir8 = np.clip(ir, 0, 255).astype(np.uint8)
        pyr = vo.last_pyr
        ok = jnp.zeros(cfg.max_landmarks, bool)
        refined = jnp.zeros((cfg.max_landmarks, 2), jnp.float32)
        args_kf = (vo.map, 0, jnp.asarray(False), vo.R, vo.t, 99, pyr,
                   img_dev, jnp.asarray(ir8), ok, refined, jnp.asarray(False))
        t = timeit(lambda: jax.block_until_ready(kf(*args_kf)), 5)
        print(f"stereo KF insert kernel : {t*1e3:8.2f} ms")

    # 5. Window BA.
    bak = vo._kernels.get("ba")
    if bak is not None:
        cam_fixed = jnp.zeros(cfg.max_keyframes, bool).at[0].set(True)
        slot = vo.kf_order[-1]
        t = timeit(
            lambda: jax.block_until_ready(bak(vo.map, cam_fixed, slot)), 5
        )
        print(f"window BA kernel        : {t*1e3:8.2f} ms")

    # 6. Full process() on a tracking frame (includes scalar readbacks).
    t0 = time.perf_counter()
    n = 0
    for il, ir in frames[10:]:
        vo.process(il, ir)
        n += 1
    print(f"process() avg           : {(time.perf_counter()-t0)/n*1e3:8.2f} ms")

    # KF cadence observed during warmup
    kfs = sum(1 for r in vo.results if r.is_keyframe)
    print(f"keyframes: {kfs}/{len(vo.results)} frames")


if __name__ == "__main__":
    main()
