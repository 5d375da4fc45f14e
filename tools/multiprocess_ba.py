"""Multi-process distributed-BA / distributed-ENGINE check (SURVEY §4d).

Spawns N CPU processes that form a jax.distributed cluster (each with 2
virtual devices) and verifies cross-process collectives — the same code
path that rides ICI/DCN on a real multi-host pod slice — in two modes:

  (default)  landmark-sharded BA solve over the global 2N-device mesh;
             every process must match the single-device final cost.
  --engine   a FULL StereoVO run with `distribute_ba=True`: per-frame
             kernels execute replicated on each process's local device,
             window BA rides the global mesh (camera blocks replicated,
             landmarks sharded, reduced system psum'd across processes),
             and the resulting trajectory must match a single-device
             run of the same frames. Keyframe cadence is pinned
             (kf_min_gap == kf_max_gap) so every process dispatches the
             identical collective sequence (SPMD discipline).

Usage:  python tools/multiprocess_ba.py [--procs 2] [--engine]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def engine_worker(proc_id: int, num_procs: int):
    """Cross-process StereoVO with distribute_ba=True (see module doc)."""
    import jax
    import numpy as np

    from viso_tpu.data import synthetic
    from viso_tpu.geometry import camera
    from viso_tpu.slam.engine import StereoVO, VOConfig
    from viso_tpu.utils import metrics

    H, W = 120, 160
    intr_kw = dict(fx=140.0, fy=140.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
    intr = camera.Intrinsics.create(**intr_kw)
    rng = np.random.default_rng(7)   # same seed on every process
    scene = synthetic.corridor_scene(rng, tex_size=512)
    n = 14
    Rs, ts = synthetic.forward_trajectory(n, step=0.25)
    frames = [
        synthetic.make_stereo_pair(scene, intr, R, t, H, W, baseline=0.3)[:2]
        for R, t in zip(Rs, ts)
    ]

    def cfg(**kw):
        return VOConfig(
            height=H, width=W, baseline=0.3, max_keyframes=4,
            max_landmarks=256, num_features=96, detect_grid=(3, 4),
            fast_threshold=8.0, max_disparity=48, ba_iters=4,
            # Pinned cadence: keyframe decisions must not depend on
            # async stats timing — every process has to dispatch the
            # exact same collective sequence.
            kf_min_gap=4, kf_max_gap=4,
            **intr_kw, **kw,
        )

    def run(**kw):
        vo = StereoVO(cfg(**kw))
        for il, ir in frames:
            vo.process(il, ir)
        R_est, t_est = vo.trajectory()
        vo.close()
        return metrics.camera_centers(R_est, t_est)

    c_single = run()
    c_dist = run(distribute_ba=True)
    c_gt = metrics.camera_centers(Rs, ts)
    ate_s = metrics.ate_rmse(c_single, c_gt, align=True, with_scale=False)
    ate_d = metrics.ate_rmse(c_dist, c_gt, align=True, with_scale=False)
    diff = float(np.abs(c_single - c_dist).max())
    ok = ate_s < 0.08 and ate_d < 0.08 and diff < 0.05
    print(
        f"[proc {proc_id}] ENGINE devices={jax.device_count()} "
        f"(local {jax.local_device_count()}) ate_single={ate_s:.4f} "
        f"ate_dist={ate_d:.4f} max_diff={diff:.4f} ok={ok}",
        flush=True,
    )
    if not ok:
        sys.exit(1)


def worker(proc_id: int, num_procs: int, port: int, engine: bool = False):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_procs,
        process_id=proc_id,
    )
    if engine:
        engine_worker(proc_id, num_procs)
        return
    import numpy as np
    import jax.numpy as jnp

    from viso_tpu.backend import ba
    from viso_tpu.geometry import se3
    from viso_tpu.parallel import dist_ba, mesh as mesh_mod

    assert jax.process_count() == num_procs
    rng = np.random.default_rng(0)
    C, L = 5, 96
    pts = np.stack(
        [rng.uniform(-4, 4, L), rng.uniform(-3, 3, L), rng.uniform(8, 16, L)],
        axis=-1,
    ).astype(np.float32)
    Rs, ts, obs, mask = [], [], [], []
    for c in range(C):
        xi = jnp.asarray(
            [0.4 * c, 0.05 * c, 0.02 * c, 0.01 * c, -0.02 * c, 0.005 * c],
            jnp.float32,
        )
        R_c, t_c = se3.se3_exp(xi)
        Rs.append(np.asarray(R_c))
        ts.append(np.asarray(t_c))
        pc = pts @ np.asarray(R_c).T + np.asarray(t_c)
        obs.append(pc[:, :2] / pc[:, 2:3] + rng.normal(0, 1e-3, (L, 2)))
        mask.append(pc[:, 2] > 1.0)
    R0 = np.stack(Rs).copy()
    t0 = np.stack(ts).copy()
    for c in range(2, C):
        dR, dt = se3.se3_exp(jnp.asarray(rng.normal(0, 0.02, 6), jnp.float32))
        R0[c] = np.asarray(dR) @ R0[c]
        t0[c] = np.asarray(dR) @ t0[c] + np.asarray(dt)
    prob = ba.BAProblem(
        R=jnp.asarray(R0),
        t=jnp.asarray(t0),
        points=jnp.asarray(pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)),
        obs_uv=jnp.asarray(np.stack(obs), jnp.float32),
        obs_mask=jnp.asarray(np.stack(mask)),
        cam_mask=jnp.ones(C, bool),
        point_mask=jnp.ones(L, bool),
    )
    params = ba.BAParams(iters=8, num_fixed=2)
    # Reference: single-device local solve.
    out_local, info_local = ba.solve(prob, params)
    # Distributed over the global mesh (all processes' devices).
    mesh = mesh_mod.make_mesh()
    assert mesh.devices.size == 2 * num_procs, mesh.devices
    out_dist, info_dist = dist_ba.solve_sharded(prob, params, mesh)
    c_local = float(info_local["final_cost"])
    c_dist = float(info_dist["final_cost"])
    ok = abs(c_local - c_dist) <= 1e-3 * max(abs(c_local), 1e-9)
    print(
        f"[proc {proc_id}] devices={jax.device_count()} "
        f"local={c_local:.6g} dist={c_dist:.6g} ok={ok}",
        flush=True,
    )
    if not ok:
        sys.exit(1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--port", type=int, default=29571)
    ap.add_argument("--engine", action="store_true",
                    help="run the full StereoVO engine with distribute_ba")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.procs, args.port, engine=args.engine)
        return
    procs = []
    for pid in range(args.procs):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.abspath(os.path.dirname(__file__) + "/..")
        env["JAX_PLATFORMS"] = "cpu"
        cmd = [
            sys.executable, os.path.abspath(__file__),
            "--worker", str(pid),
            "--procs", str(args.procs),
            "--port", str(args.port),
        ]
        if args.engine:
            cmd.append("--engine")
        procs.append(subprocess.Popen(cmd, env=env))
    rc = 0
    for p in procs:
        rc |= p.wait()
    if rc == 0:
        kind = "ENGINE" if args.engine else "BA"
        print(f"MULTIPROCESS {kind} OK ({args.procs} processes)")
    sys.exit(rc)


if __name__ == "__main__":
    main()
