"""Window-BA backend shoot-out: reprojection vs photometric.

Runs the same synthetic stereo corridor through StereoVO twice — once
per backend — and reports ATE + wall-clock per keyframe-BA call. The
photometric backend realizes the reference's stated intent (16-dim
4x4-patch intensity residuals, bundle_adjuster.h:58-106); reprojection
is the geometric default for stereo.

Usage: python tools/bench_backends.py [--frames 40]
(bench.py calls `compare` in its own process.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_backend(backend, frames, cfg_kw):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from viso_tpu.slam.engine import StereoVO, VOConfig
    from viso_tpu.utils import metrics

    vo = StereoVO(VOConfig(ba_backend=backend, **cfg_kw))
    t0 = time.perf_counter()
    for il, ir in frames:
        vo.process(il, ir)
    jax.block_until_ready((vo.R, vo.t))
    wall = time.perf_counter() - t0
    # Time the CACHED BA executable directly with a pipelined burst:
    # blocking inside the frame loop would measure the whole queued
    # pipeline (the engine overlaps BA with tracking).
    ba_times = []
    if "ba" in vo._kernels:
        cam_fixed = np.zeros(vo.cfg.max_keyframes, bool)
        cam_fixed[vo.kf_order[0]] = True
        args = (vo.map, jnp.asarray(cam_fixed), vo.kf_order[-1], vo.R, vo.t)
        out = vo._kernels["ba"](*args)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        n = 16
        tb = time.perf_counter()
        for _ in range(n):
            out = vo._kernels["ba"](*args)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        ba_times = [(time.perf_counter() - tb) / n]
    R_est, t_est = vo.trajectory()
    vo.close()
    return metrics.camera_centers(R_est, t_est), ba_times, wall


def compare(frames=40):
    """One record per backend: ATE, ms per keyframe BA, wall time."""
    from viso_tpu.data import synthetic
    from viso_tpu.geometry import camera
    from viso_tpu.utils import metrics

    H, W = 240, 768
    intr_kw = dict(fx=360.0, fy=360.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
    cfg_kw = dict(
        height=H, width=W, baseline=0.5, num_features=256,
        max_landmarks=1024, detect_grid=(4, 8), fast_threshold=15.0,
        max_disparity=96, kf_min_gap=2, kf_max_gap=6, **intr_kw,
    )
    rng = np.random.default_rng(42)
    scene = synthetic.corridor_scene(rng, tex_size=1024)
    intr = camera.Intrinsics.create(**intr_kw)
    Rs, ts = synthetic.forward_trajectory(frames, step=0.5, yaw_rate=0.003)
    imgs = [
        synthetic.make_stereo_pair(scene, intr, R, t, H, W, baseline=0.5)[:2]
        for R, t in zip(Rs, ts)
    ]
    c_gt = metrics.camera_centers(Rs, ts)

    recs = []
    for backend in ("reprojection", "photometric"):
        c_est, ba_times, wall = run_backend(backend, imgs, cfg_kw)
        ate = metrics.ate_rmse(c_est, c_gt, align=True, with_scale=False)
        recs.append({
            "backend": backend,
            "ate_rmse_m": round(float(ate), 4),
            "ba_ms_per_keyframe": round(
                1e3 * float(np.mean(ba_times)), 2
            ) if ba_times else None,
            "wall_s": round(wall, 2),
        })
    return recs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args()

    from viso_tpu.utils import compile_cache

    compile_cache.enable()
    for rec in compare(args.frames):
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
