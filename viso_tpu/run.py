"""CLI runner: visual odometry / SLAM over datasets.

Replaces the reference's hard-coded `main()` (`/root/reference/src/
main.cpp:14-17,46` — fixed TUM intrinsics + "rgb/" path) with a
configurable driver:

  python -m viso_tpu.run --dataset kitti --root /data/kitti --sequence 00 \
      --mode stereo --max-frames 500 --out-dir out/

Writes trajectory (KITTI format), JSONL per-frame log, trajectory plot,
and — when the dataset ships ground truth — ATE/RPE metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np


def build_engine(seq, args):
    from viso_tpu.slam.engine import MonocularVO, StereoVO, VOConfig
    from viso_tpu.slam.full import StereoSLAM

    intr = seq.intrinsics
    h, w = args.height, args.width
    cfg = VOConfig(
        height=h,
        width=w,
        fx=float(intr.fx),
        fy=float(intr.fy),
        cx=float(intr.cx),
        cy=float(intr.cy),
        baseline=seq.baseline or 0.537,
        num_features=args.num_features,
        max_landmarks=args.max_landmarks,
        max_keyframes=args.max_keyframes,
        fast_threshold=args.fast_threshold,
        ba_backend=args.ba_backend,
        distribute_ba=args.distribute,
        mesh_devices=args.mesh_devices,
    )
    if args.init_disparity_px:
        cfg = dataclasses.replace(
            cfg, disparity_squared_thresh=args.init_disparity_px ** 2
        )
    if args.detect_levels:
        cfg = dataclasses.replace(cfg, detect_levels=args.detect_levels)
    if args.mode == "mono":
        return MonocularVO(cfg)
    if args.mode == "stereo":
        return StereoVO(cfg)
    if args.mode == "mono-slam":
        from viso_tpu.slam.loop_closure import LoopParams
        from viso_tpu.slam.mono_full import MonoSLAM

        lp = LoopParams()
        lp = dataclasses.replace(
            lp,
            min_inliers=args.loop_min_inliers or lp.min_inliers,
            min_matches=args.loop_min_matches or lp.min_matches,
            guard=args.loop_guard or lp.guard,
            max_correction_m=args.loop_max_correction_m
            or lp.max_correction_m,
            trans_drift_rate=args.loop_trans_drift_rate
            or lp.trans_drift_rate,
            rot_drift_rate=args.loop_rot_drift_rate or lp.rot_drift_rate,
        )
        return MonoSLAM(cfg, lp)
    if args.mode == "slam":
        from viso_tpu.slam.loop_closure import LoopParams

        lp = LoopParams()
        lp = dataclasses.replace(
            lp,
            min_inliers=args.loop_min_inliers or lp.min_inliers,
            min_matches=args.loop_min_matches or lp.min_matches,
            guard=args.loop_guard or lp.guard,
            max_correction_m=args.loop_max_correction_m
            or lp.max_correction_m,
            trans_drift_rate=args.loop_trans_drift_rate
            or lp.trans_drift_rate,
            rot_drift_rate=args.loop_rot_drift_rate or lp.rot_drift_rate,
        )
        return StereoSLAM(cfg, lp)
    raise ValueError(args.mode)


def main(argv=None):
    ap = argparse.ArgumentParser(description="viso_tpu VO/SLAM runner")
    ap.add_argument("--dataset", choices=["kitti", "tum", "euroc", "dir", "synthetic"],
                    default="synthetic")
    ap.add_argument("--root", default="")
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--mode", choices=["mono", "stereo", "slam", "mono-slam"], default="stereo")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--num-features", type=int, default=512)
    ap.add_argument("--max-landmarks", type=int, default=2048)
    ap.add_argument("--max-keyframes", type=int, default=8)
    ap.add_argument("--fast-threshold", type=float, default=20.0)
    # Two-view init disparity gate in px (reference: 15, viso.h:24 —
    # tuned for lateral motion; forward-dominant sequences need ~5).
    # 0 = keep the config default.
    ap.add_argument("--init-disparity-px", type=float, default=0.0)
    # Window-BA residual type; "photometric" is the reference's stated
    # backend intent (bundle_adjuster.h:58-106). "auto" = photometric
    # for mono, reprojection for stereo/slam.
    ap.add_argument("--ba-backend",
                    choices=["auto", "reprojection", "photometric"],
                    default="auto")
    # Distributed window BA over every visible device (north-star
    # config 5): landmark-sharded LM+Schur, reduced camera system psum'd
    # over the mesh (parallel/dist_ba.py).
    ap.add_argument("--distribute", action="store_true")
    ap.add_argument("--mesh-devices", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--width", type=int, default=0)
    # Multi-scale FAST levels (0 = config default of 3; 1 = single-scale).
    ap.add_argument("--detect-levels", type=int, default=0)
    # Loop-closure knobs (slam mode; 0 = LoopParams default). The
    # plausibility gate is drift-scaled — see slam/loop_closure.LoopParams.
    ap.add_argument("--loop-min-inliers", type=int, default=0)
    ap.add_argument("--loop-min-matches", type=int, default=0)
    ap.add_argument("--loop-guard", type=int, default=0)
    ap.add_argument("--loop-max-correction-m", type=float, default=0.0)
    ap.add_argument("--loop-trans-drift-rate", type=float, default=0.0)
    ap.add_argument("--loop-rot-drift-rate", type=float, default=0.0)
    # Per-frame debug overlays (the reference's cv::imshow rectangles,
    # viso.cpp:123-135, headless): every N frames write
    # out-dir/overlays/frame_XXXXXX.png with tracked landmarks drawn on
    # the current image. Each overlay costs one device->host image pull,
    # so 0 (off) is the default for benchmarking.
    ap.add_argument("--viz-every", type=int, default=0)
    ap.add_argument("--out-dir", default="out")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", default="")
    args = ap.parse_args(argv)

    from viso_tpu.data import datasets, synthetic
    from viso_tpu.utils import checkpoint, compile_cache, logging as vlog
    from viso_tpu.utils import metrics, viz

    compile_cache.enable()
    os.makedirs(args.out_dir, exist_ok=True)

    if args.dataset == "kitti":
        seq = datasets.load_kitti(
            args.root, args.sequence, stereo=args.mode != "mono",
            max_frames=args.max_frames,
        )
    elif args.dataset == "tum":
        seq = datasets.load_tum(args.root, max_frames=args.max_frames)
    elif args.dataset == "euroc":
        seq = datasets.load_euroc(
            args.root, max_frames=args.max_frames,
            stereo=args.mode != "mono",
        )
    elif args.dataset == "dir":
        from viso_tpu.geometry import camera

        seq = datasets.Sequence(
            frames=datasets.load_image_dir(args.root),
            intrinsics=camera.Intrinsics.create(**datasets.TUM_FREIBURG1),
            name="dir",
        )
    else:  # synthetic smoke run
        from viso_tpu.geometry import camera

        h, w = 240, 320
        intr = camera.Intrinsics.create(260.0, 260.0, w / 2 - 0.5, h / 2 - 0.5)
        rng = np.random.default_rng(0)
        scene = synthetic.corridor_scene(rng)
        n = args.max_frames or 30
        Rs, ts = synthetic.forward_trajectory(n, step=0.4)
        if args.mode in ("mono", "mono-slam") and not args.init_disparity_px:
            # Forward motion yields small radial flow; the reference's
            # 15 px lateral-motion gate would never accept an init here.
            args.init_disparity_px = 5.0

        def gen():
            for i, (R, t) in enumerate(zip(Rs, ts)):
                il, ir, _ = synthetic.make_stereo_pair(scene, intr, R, t, h, w, 0.4)
                yield datasets.Frame(index=i, image=il, image_right=ir)

        seq = datasets.Sequence(
            frames=gen(), intrinsics=intr, baseline=0.4,
            gt_R=Rs, gt_t=ts, name="synthetic",
        )

    frames_iter = iter(seq.frames)
    first = next(frames_iter)
    if not args.height:
        args.height, args.width = first.image.shape
    vo = build_engine(seq, args)
    if args.resume:
        if args.mode in ("slam", "mono-slam"):
            # Full SLAM restore (map + pose graph + loop DB): swap the
            # freshly-built engine for the checkpointed one.
            vo.close()
            vo, extra = checkpoint.load_slam(
                args.resume, vo.cfg, vo.loop_params
            )
        else:
            vo.map, extra = checkpoint.load_map(args.resume)
        print(f"resumed from {args.resume}: {extra}")

    log = vlog.RunLogger(path=os.path.join(args.out_dir, "frames.jsonl"))
    log.tick()

    overlay_dir = os.path.join(args.out_dir, "overlays")
    if args.viz_every:
        os.makedirs(overlay_dir, exist_ok=True)
        vo.debug_overlay = True

    def write_overlay(index):
        if vo._last_track is None:
            return
        # Skip stale overlays (init / re-init frames record no track).
        if vo._last_track[3] != vo.frame_idx:
            return
        from viso_tpu.data import png_io

        ok, uv, img = (np.asarray(a) for a in vo._last_track[:3])
        rgb = viz.draw_keypoints(img, uv, ok)
        png_io.write_rgb_png(
            os.path.join(overlay_dir, f"frame_{index:06d}.png"), rgb
        )

    def step(frame):
        if args.mode in ("mono", "mono-slam"):
            return vo.process(frame.image)
        return vo.process(frame.image, frame.image_right)

    import itertools

    # Source indices of processed frames: dataset readers may skip
    # unreadable frames (e.g. EuRoC pairs), so ground truth must be
    # paired by Frame.index, not by position (ADVICE r3).
    processed_idx: list[int] = []
    for frame in itertools.chain([first], frames_iter):
        r = step(frame)
        processed_idx.append(frame.index)
        log.log_frame(
            frame.index,
            num_tracked=r.num_tracked,
            num_landmarks=r.num_landmarks,
            num_keyframes=len(vo.kf_order),
            is_keyframe=r.is_keyframe,
            state=r.state,
        )
        if args.viz_every and frame.index % args.viz_every == 0:
            write_overlay(frame.index)
        if args.checkpoint_every and frame.index and frame.index % args.checkpoint_every == 0:
            if args.mode in ("slam", "mono-slam"):
                checkpoint.save_slam(
                    os.path.join(args.out_dir, "slam.npz"), vo,
                    extra={"frame": frame.index},
                )
            else:
                checkpoint.save_map(
                    os.path.join(args.out_dir, "map.npz"), vo.map,
                    extra={"frame": frame.index},
                )

    R_est, t_est = vo.trajectory()
    checkpoint.save_trajectory(os.path.join(args.out_dir, "trajectory.txt"), R_est, t_est)
    summary = log.summary()
    summary["sequence"] = seq.name

    if seq.gt_R is not None:
        n = len(R_est)
        sel = np.asarray(processed_idx[:n])
        gt_R = np.asarray(seq.gt_R)[sel]
        gt_t = np.asarray(seq.gt_t)[sel]
        c_est = metrics.camera_centers(R_est, t_est)
        c_gt = metrics.camera_centers(gt_R, gt_t)
        with_scale = args.mode in ("mono", "mono-slam")
        summary["ate_rmse_m"] = metrics.ate_rmse(
            c_est, c_gt, align=True, with_scale=with_scale
        )
        trans_rpe, rot_rpe = metrics.rpe(R_est, t_est, gt_R, gt_t)
        summary["rpe_trans_m"] = trans_rpe
        summary["rpe_rot_deg"] = rot_rpe
        viz.plot_trajectory(
            R_est, t_est, gt_R, gt_t,
            path=os.path.join(args.out_dir, "trajectory.png"),
        )
    else:
        viz.plot_trajectory(
            R_est, t_est, path=os.path.join(args.out_dir, "trajectory.png"),
        )

    # Final top-down map render (the reference's Pangolin DrawMap view,
    # main.cpp:56-103, as a file): landmarks + keyframe frusta markers.
    viz.plot_map_topdown(
        np.asarray(vo.map.points), np.asarray(vo.map.point_mask),
        kf_R=np.asarray(vo.map.kf_R)[list(vo.kf_order)] if vo.kf_order else None,
        kf_t=np.asarray(vo.map.kf_t)[list(vo.kf_order)] if vo.kf_order else None,
        path=os.path.join(args.out_dir, "map_topdown.png"),
    )
    # Interactive 3-D viewer (the reference's Pangolin window,
    # main.cpp:56-103, as a self-contained HTML artifact).
    viz.export_map_html(
        np.asarray(vo.map.points), np.asarray(vo.map.point_mask),
        metrics.camera_centers(R_est, t_est),
        path=os.path.join(args.out_dir, "map.html"),
    )

    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    log.close()
    return summary


if __name__ == "__main__":
    main()
