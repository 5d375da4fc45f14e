"""Secondary benchmark: BA iterations/s on a 50-keyframe window.

The north-star metric set (BASELINE.md) includes "BA iterations/s on a
50-keyframe window". Builds a synthetic 50-camera x 4096-landmark
problem (~60k observations) and times backend/ba LM iterations.

Usage: python tools/bench_ba.py [--cams 50] [--landmarks 4096]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_problem(C=50, L=4096, seed=0):
    """Synthetic C-camera x L-landmark window (~60k observations at the
    defaults) with perturbed initial poses and points, as host arrays."""
    import jax.numpy as jnp

    from viso_tpu.backend import ba
    from viso_tpu.geometry import se3

    rng = np.random.default_rng(seed)
    pts = np.stack(
        [rng.uniform(-10, 10, L), rng.uniform(-4, 4, L), rng.uniform(5, 60, L)],
        axis=-1,
    ).astype(np.float32)
    Rs = np.zeros((C, 3, 3), np.float32)
    ts = np.zeros((C, 3), np.float32)
    obs = np.zeros((C, L, 2), np.float32)
    mask = np.zeros((C, L), bool)
    for c in range(C):
        xi = jnp.asarray(
            [0.5 * c, 0.01 * c, 0.0, 0.0, 0.002 * c, 0.0], jnp.float32
        )
        R_c, t_c = se3.se3_exp(xi)
        Rs[c], ts[c] = np.asarray(R_c), np.asarray(t_c)
        pc = pts @ Rs[c].T + ts[c]
        ok = (pc[:, 2] > 1.0) & (np.abs(pc[:, 0] / pc[:, 2]) < 0.9)
        uv = pc[:, :2] / np.maximum(pc[:, 2:3], 1e-3)
        obs[c] = uv + rng.normal(0, 1.0 / 700, uv.shape)
        mask[c] = ok
    # Perturb initialization.
    R0, t0 = Rs.copy(), ts.copy()
    for c in range(2, C):
        dR, dt = se3.se3_exp(jnp.asarray(rng.normal(0, 0.01, 6), jnp.float32))
        R0[c] = np.asarray(dR) @ R0[c]
        t0[c] = np.asarray(dR) @ t0[c] + np.asarray(dt)
    return ba.BAProblem(
        R=R0, t=t0,
        points=pts + rng.normal(0, 0.1, pts.shape).astype(np.float32),
        obs_uv=obs, obs_mask=mask,
        cam_mask=np.ones(C, bool), point_mask=np.ones(L, bool),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=50)
    ap.add_argument("--landmarks", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--unroll", type=int, default=1)
    ap.add_argument("--solver", type=str, default="lu")
    args = ap.parse_args()

    from viso_tpu.backend import ba
    from viso_tpu.utils import compile_cache

    compile_cache.enable()
    C, L = args.cams, args.landmarks
    prob = make_problem(C, L)
    params = ba.BAParams(
        iters=args.iters, num_fixed=2, unroll=args.unroll,
        solver=args.solver,
    )
    out, info = ba.solve(prob, params)  # compile
    float(info["final_cost"])
    # Dispatch n_rep solves back-to-back and force ONE readback at the
    # end, so per-call dispatch latency pipelines on the device.
    n_rep = 10
    t0_ = time.perf_counter()
    for _ in range(n_rep):
        out, info = ba.solve(prob, params)
    float(info["final_cost"])
    dt = (time.perf_counter() - t0_) / n_rep
    iters_per_s = args.iters / dt
    print(
        json.dumps(
            {
                "metric": f"ba_iters_per_s_{C}kf_{L}lm",
                "value": round(iters_per_s, 2),
                "unit": "LM iterations/s",
                "num_obs": int(info["num_obs"]),
                "initial_cost": float(info["initial_cost"]),
                "final_cost": float(info["final_cost"]),
            }
        )
    )


if __name__ == "__main__":
    main()
