"""Loop-gate diagnostics on the 500-frame orbit bench sequence.

Runs the exact bench_long_slam configuration with LoopDatabase.debug
enabled and prints every candidate's gate inputs (d_trans/d_rot vs the
drift-scaled bounds) and decision, plus the final ATE with and without
the accepted corrections.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from viso_tpu.utils import compile_cache

    compile_cache.enable()
    import jax

    import bench
    from viso_tpu.data import native
    from viso_tpu.slam.engine import VOConfig
    from viso_tpu.slam.full import StereoSLAM
    from viso_tpu.slam.loop_closure import LoopParams
    from viso_tpu.utils import metrics

    n_frames = 500
    H, W = 184, 616
    root, Rs, ts = bench._ensure_png_sequence(H, W, n_frames)
    paths = []
    for i in range(n_frames):
        paths.append(os.path.join(root, f"L{i:04d}.png"))
        paths.append(os.path.join(root, f"R{i:04d}.png"))

    cfg = VOConfig(
        height=H, width=W, baseline=0.537,
        fx=bench.KITTI_FULL["fx"] / 2, fy=bench.KITTI_FULL["fy"] / 2,
        cx=bench.KITTI_FULL["cx"] / 2, cy=bench.KITTI_FULL["cy"] / 2,
        num_features=256, max_landmarks=1024, detect_grid=(4, 8),
        fast_threshold=6.0, max_disparity=96,
        stats_max_lag=8, kf_max_gap=8, kf_min_gap=2,
    )
    slam = StereoSLAM(cfg, LoopParams(min_inliers=40, max_correction_m=4.0))
    slam.loop_db.debug = []
    trace = os.environ.get("VISO_DIAG_TRACE") == "1"
    if trace:
        orig_track = slam._track_landmarks
        orig_opt = slam._optimize_pose_graph

        def ptrack(img):
            out = orig_track(img)
            n = int(np.asarray(out[0]).sum())
            c = -np.asarray(slam.R).T @ np.asarray(slam.t)
            f = slam.frame_idx
            c_gt = -Rs[f].T @ ts[f]
            print(
                f"[trace] f{f} align={n} err={np.linalg.norm(c - c_gt):.3f}",
                file=sys.stderr,
            )
            return out

        def popt():
            c0 = -np.asarray(slam.R).T @ np.asarray(slam.t)
            orig_opt()
            c1 = -np.asarray(slam.R).T @ np.asarray(slam.t)
            print(
                f"[trace] EVENT f{slam.frame_idx} K={len(slam.pg_R)} "
                f"moved={np.linalg.norm(c1 - c0):.3f}",
                file=sys.stderr,
            )

        slam._track_landmarks = ptrack
        slam._optimize_pose_graph = popt
    pre = native.Prefetcher(paths, ring=16, threads=3)
    for _ in range(n_frames):
        il = np.clip(next(pre), 0, 255).astype(np.uint8)
        ir = np.clip(next(pre), 0, 255).astype(np.uint8)
        slam.process(il, ir)
    jax.block_until_ready((slam.R, slam.t))
    pre.close()
    slam.join()
    for rec in slam.loop_db.debug:
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in rec.items()}))
    R_est, t_est = slam.trajectory()
    slam.close()
    c_est = metrics.camera_centers(R_est, t_est)
    c_gt = metrics.camera_centers(Rs, ts)
    ate = metrics.ate_rmse(c_est, c_gt, align=True, with_scale=False)
    print(
        json.dumps(
            dict(ate=float(ate), loops=len(slam.loops),
                 candidates=len(slam.loop_db.debug))
        )
    )
    # Edge-residual post-mortem: worst edges at the final solution.
    from viso_tpu.backend import pose_graph as pg
    import jax.numpy as jnp

    for name, (Rset, tset) in (
        ("solved", (slam.pg_R, slam.pg_t)),
        ("raw", (slam.pg_raw_R, slam.pg_raw_t)),
    ):
        g, _ = pg.solve_padded(Rset, tset, slam.pg_edges, pg.PGParams(iters=0))
        r = np.asarray(pg.residuals(g))
        rn = np.linalg.norm(r, axis=-1)[: len(slam.pg_edges)]
        worst = np.argsort(-rn)[:8]
        n_seq = sum(1 for e in slam.pg_edges if abs(e[0] - e[1]) == 1)
        for w in worst:
            i, j, _, _, wt = slam.pg_edges[w]
            kind = "seq" if abs(i - j) == 1 else "loop"
            print(
                json.dumps(
                    dict(config=name, edge=int(w), kind=kind, i=int(i),
                         j=int(j), weight=float(wt), resid=float(rn[w]))
                ),
                file=sys.stderr,
            )
        print(
            f"[{name}] edges: {n_seq} seq + "
            f"{len(slam.pg_edges) - n_seq} loop; "
            f"median resid {np.median(rn):.4f}",
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
