"""Distributed-BA harness on a virtual CPU mesh.

Measures LM iterations/s vs mesh size on virtual CPU devices
(XLA_FLAGS=--xla_force_host_platform_device_count=N). Virtual devices
share host cores, so this checks the sharded path's correctness and
overhead, not real scaling; the multi-card evidence is
`python chip_smoke.py --four-cards`. Each record also carries the bytes
all-reduced per LM iteration (dist_ba.psum_bytes_per_iter).

Usage:
  python tools/bench_dist_ba.py [--cams 16] [--landmarks 65536]
        [--devices 1 2 4 8] [--iters 10]

Prints one JSON line per mesh size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=16)
    ap.add_argument("--landmarks", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args()

    max_dev = max(args.devices)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={max_dev}"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from viso_tpu.backend import ba
    from viso_tpu.geometry import se3
    from viso_tpu.parallel import dist_ba, mesh as mesh_mod

    C, L = args.cams, args.landmarks
    rng = np.random.default_rng(0)
    pts = np.stack(
        [rng.uniform(-10, 10, L), rng.uniform(-4, 4, L), rng.uniform(5, 60, L)],
        axis=-1,
    ).astype(np.float32)
    Rs = np.zeros((C, 3, 3), np.float32)
    ts = np.zeros((C, 3), np.float32)
    obs = np.zeros((C, L, 2), np.float32)
    mask = np.zeros((C, L), bool)
    for c in range(C):
        R_c, t_c = se3.se3_exp(
            jnp.asarray([0.5 * c, 0.01 * c, 0, 0, 0.002 * c, 0], jnp.float32)
        )
        Rs[c], ts[c] = np.asarray(R_c), np.asarray(t_c)
        pc = pts @ Rs[c].T + ts[c]
        mask[c] = (pc[:, 2] > 1.0) & (np.abs(pc[:, 0] / pc[:, 2]) < 0.9)
        obs[c] = pc[:, :2] / np.maximum(pc[:, 2:3], 1e-3)
    prob = ba.BAProblem(
        R=jnp.asarray(Rs), t=jnp.asarray(ts),
        points=jnp.asarray(pts + rng.normal(0, 0.1, pts.shape).astype(np.float32)),
        obs_uv=jnp.asarray(obs), obs_mask=jnp.asarray(mask),
        cam_mask=jnp.ones(C, bool), point_mask=jnp.ones(L, bool),
    )
    params = ba.BAParams(iters=args.iters, num_fixed=2)

    results = []
    for n in args.devices:
        mesh = mesh_mod.make_mesh(n)
        out, info = dist_ba.solve_sharded(prob, params, mesh)  # compile
        jax.block_until_ready(out.R)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            out, info = dist_ba.solve_sharded(prob, params, mesh)
        jax.block_until_ready(out.R)
        dt = (time.perf_counter() - t0) / reps
        iters_per_s = args.iters / dt
        rec = {
            "devices": n,
            "lm_iters_per_s": round(iters_per_s, 2),
            "psum_bytes_per_iter": dist_ba.psum_bytes_per_iter(C),
            "landmarks_per_device": (L + n - 1) // n,
            "final_cost": float(info["final_cost"]),
            # Virtual devices SHARE these host cores; the single-device
            # baseline is itself multithreaded over all of them, so on
            # an m-core host the measured mesh-k "efficiency" is
            # structurally capped near m/(k*min(m,k)) — it validates the
            # sharded path's correctness and overhead, not real scaling.
            "host_cores": os.cpu_count(),
        }
        if results:
            rec["speedup_vs_1dev"] = round(
                iters_per_s / results[0]["lm_iters_per_s"], 3
            )
            rec["efficiency"] = round(rec["speedup_vs_1dev"] / n, 3)
        results.append(rec)
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
