"""Per-frame drift bisection on the 500-frame orbit bench sequence.

VERDICT r2 weak #1: ~2.25 rad of yaw drift per orbit lap at the bench's
184x616 config. This tool runs the SAME sequence/config as
bench.bench_long_slam (pure StereoVO, no loop closure) and reports the
per-frame relative-pose error vs the renderer's exact ground truth,
split by frame kind (tracked vs keyframe) so the drifting stage is
identifiable: a tracked-frame bias implicates direct tracking/alignment/
PnP-refine; keyframe-step bias implicates BA or stereo triangulation.

Usage: python tools/diag_drift.py [--frames 260] [--no-ba] [--kf-max-gap N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def rot_angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def rel(Ra, ta, Rb, tb):
    """T_a o T_b^-1."""
    R = Ra @ Rb.T
    t = ta - R @ tb
    return R, t


def main():
    from viso_tpu.utils import compile_cache

    compile_cache.enable()
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=260)
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument("--kf-max-gap", type=int, default=8)
    ap.add_argument("--kf-min-gap", type=int, default=2)
    ap.add_argument("--features", type=int, default=256)
    ap.add_argument("--landmarks", type=int, default=1024)
    ap.add_argument("--fast-threshold", type=float, default=6.0)
    ap.add_argument("--ba-iters", type=int, default=8)
    ap.add_argument("--direct-iters", type=int, default=10)
    ap.add_argument("--align-iters", type=int, default=10)
    ap.add_argument("--dump", default="", help="npz path for per-frame data")
    args = ap.parse_args()

    import jax

    import bench
    from viso_tpu.data import native
    from viso_tpu.slam.engine import StereoVO, VOConfig

    H, W = 184, 616
    root, Rs_gt, ts_gt = bench._ensure_png_sequence(H, W, 500)
    n = args.frames
    paths = []
    for i in range(n):
        paths.append(os.path.join(root, f"L{i:04d}.png"))
        paths.append(os.path.join(root, f"R{i:04d}.png"))

    cfg = VOConfig(
        height=H, width=W, baseline=0.537,
        fx=bench.KITTI_FULL["fx"] / 2, fy=bench.KITTI_FULL["fy"] / 2,
        cx=bench.KITTI_FULL["cx"] / 2, cy=bench.KITTI_FULL["cy"] / 2,
        num_features=args.features, max_landmarks=args.landmarks,
        detect_grid=(4, 8),
        fast_threshold=args.fast_threshold, max_disparity=96,
        stats_max_lag=8, kf_max_gap=args.kf_max_gap,
        kf_min_gap=args.kf_min_gap,
        run_ba=not args.no_ba, ba_iters=args.ba_iters,
        direct_iters=args.direct_iters, align_iters=args.align_iters,
    )
    vo = StereoVO(cfg)
    pre = native.Prefetcher(paths, ring=16, threads=3)
    for _ in range(n):
        il = np.clip(next(pre), 0, 255).astype(np.uint8)
        ir = np.clip(next(pre), 0, 255).astype(np.uint8)
        vo.process(il, ir)
    jax.block_until_ready((vo.R, vo.t))
    pre.close()
    R_est, t_est = vo.trajectory()
    kf_flags = np.array([r.is_keyframe for r in vo.results])
    n_tracked = np.array([r.num_tracked for r in vo.results])
    vo.close()

    # Per-frame relative-pose error: E_i = rel_est_i * rel_gt_i^-1.
    yaw_err = np.zeros(n)          # signed yaw (about cam y) error/frame
    rot_err = np.zeros(n)          # total angle error/frame
    trans_err = np.zeros(n)
    for i in range(1, n):
        Re, te = rel(R_est[i], t_est[i], R_est[i - 1], t_est[i - 1])
        Rg, tg = rel(Rs_gt[i], ts_gt[i], Rs_gt[i - 1], ts_gt[i - 1])
        E = Re @ Rg.T
        rot_err[i] = rot_angle(E)
        # Signed rotation about the camera y axis (yaw): use the
        # axis-angle decomposition's y component.
        w = np.array([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0], E[1, 0] - E[0, 1]])
        yaw_err[i] = 0.5 * w[1]
        trans_err[i] = np.linalg.norm(te - tg)

    # Accumulated world-yaw drift at the end (what the loop gate sees).
    E_end = R_est[n - 1] @ Rs_gt[n - 1].T @ (R_est[0] @ Rs_gt[0].T).T
    kf = kf_flags.astype(bool)
    tr = ~kf
    out = {
        "frames": n,
        "keyframes": int(kf.sum()),
        "total_rot_drift_rad": rot_angle(E_end),
        "sum_signed_yaw_err_rad": float(yaw_err.sum()),
        "per_frame_rot_err_mean_rad": float(rot_err[1:].mean()),
        "tracked_yaw_bias_rad_per_frame": float(yaw_err[tr][1:].mean())
        if tr.sum() > 1 else 0.0,
        "keyframe_yaw_bias_rad_per_frame": float(yaw_err[kf].mean())
        if kf.sum() else 0.0,
        "tracked_trans_err_mean_m": float(trans_err[tr][1:].mean()),
        "keyframe_trans_err_mean_m": float(trans_err[kf].mean())
        if kf.sum() else 0.0,
        "mean_n_tracked": float(n_tracked[5:].mean()),
        "min_n_tracked": int(n_tracked[5:].min()),
    }
    # ATE for reference.
    from viso_tpu.utils import metrics

    c_est = metrics.camera_centers(R_est, t_est)
    c_gt = metrics.camera_centers(Rs_gt[:n], ts_gt[:n])
    out["ate_rmse_m"] = float(
        metrics.ate_rmse(c_est, c_gt, align=True, with_scale=False)
    )
    print(json.dumps(out, indent=1))
    if args.dump:
        np.savez(
            args.dump, yaw_err=yaw_err, rot_err=rot_err,
            trans_err=trans_err, kf=kf_flags, n_tracked=n_tracked,
            R_est=R_est, t_est=t_est, R_gt=Rs_gt[:n], t_gt=ts_gt[:n],
        )


if __name__ == "__main__":
    main()
