"""Benchmark suite. Prints ONE JSON line with the headline metric
(stereo VO frames/s per chip) plus the full north-star metric set in
"extra" (BASELINE.md): BA iterations/s on a 50-keyframe window, ATE on a
500-frame loop-closure sequence, and an end-to-end FPS that INCLUDES
PNG decode + host->device transfer through the native prefetch ring.

  {"metric": "stereo_vo_fps_per_chip", "value": N, "unit": "frames/s",
   "vs_baseline": N, "extra": {...}}

Baseline: the north-star target of 10 FPS real-time stereo VO per chip
(BASELINE.md; the reference publishes no numbers). vs_baseline = fps / 10.

Runs on the GPU and fails without one. JAX_PLATFORMS=cpu, set
explicitly, runs the same code on the CPU as a rehearsal: its record
carries no device shares. VISO_BENCH_QUICK=1 skips everything but the
headline metric. Every record names the device it ran on.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

KITTI_FULL = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157)

# Published peaks per `device_kind`, used to turn measured device time
# into utilization shares. Source: NVIDIA H100 SXM data sheet (dense
# fp32 outside the tensor cores; HBM3 bandwidth), at the full 700 W
# power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}


def peaks(device_kind: str) -> dict:
    """Published peaks for `device_kind`; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add "
            "them to bench.PEAKS with their source"
        ) from None


def headline_config(**overrides):
    """The headline stereo configuration: KITTI odometry geometry
    (1240x376, f=718.856, 0.537 m baseline), 512 features, 2048
    landmark slots, a 6x12 detection grid, 128 px disparity search."""
    from viso_tpu.slam.engine import VOConfig

    kw = dict(
        height=376,
        width=1240,
        baseline=0.537,
        num_features=512,
        max_landmarks=2048,
        detect_grid=(6, 12),
        fast_threshold=20.0,
        max_disparity=128,
        # Deep stats fetches, so the dispatch loop never joins a
        # readback, and keyframes on a bounded schedule, so cadence does
        # not depend on stats freshness. Not yet re-measured on the GPU
        # (ROADMAP Speed item 5).
        stats_max_lag=8,
        kf_max_gap=5,
        **KITTI_FULL,
    )
    kw.update(overrides)
    return VOConfig(**kw)


# The monocular cells' VOConfig tuning.
MONO_TUNING = dict(
    kf_max_gap=8, kf_min_gap=2,
    # Mono needs FRESH stats for lost-tracking recovery: with the stereo
    # benches' deep pipeline (lag 8, hard 16) every sample predates the
    # last keyframe (gap 8), so recovery never fires and a mid-run
    # tracking collapse is permanent.
    stats_max_lag=2, stats_hard_lag=4, stats_deterministic=True,
    # Mono tracks a smaller fraction of its feature budget than stereo
    # (landmarks come from two-view parallax, not disparity): 0.6 would
    # fire the visibility keyframe gate every kf_min_gap.
    kf_min_visible_frac=0.45,
    # Forward-only motion: the reference's 15 px init disparity gate
    # (viso.h:24) never fires; 5 px does (run.py uses the same).
    disparity_squared_thresh=25.0,
)


def headline_sequence(cfg, n_frames, seed=42):
    """Seeded synthetic KITTI-like corridor drive at ~0.8 m/frame:
    (stereo pairs [(left, right)], gt R (N, 3, 3), gt t (N, 3))."""
    from viso_tpu.data import synthetic

    rng = np.random.default_rng(seed)
    scene = synthetic.corridor_scene(rng, tex_size=1024, far_z=60.0)
    Rs, ts = synthetic.forward_trajectory(n_frames, step=0.8, yaw_rate=0.003)
    intr = cfg.intrinsics()
    frames = [
        synthetic.make_stereo_pair(
            scene, intr, R, t, cfg.height, cfg.width, baseline=cfg.baseline
        )[:2]
        for R, t in zip(Rs, ts)
    ]
    return frames, Rs, ts


def device_metrics(vo, staged_imgs, peak, n=48):
    """Silicon numbers from the engine's OWN compiled track executable.

    Uses XLA's cost analysis of the exact executable the bench just ran
    (no separate config -> no cold compiles; VERDICT r2 weak #4), plus a
    pipelined track-kernel burst over distinct pre-staged frames for
    sustained on-device s/frame. MFU is expected single-digit — sparse
    VO is gather-bound; HBM utilization is the meaningful ceiling.
    `peak` None leaves the utilization shares out.
    """
    import jax

    track = vo._kernels["track"]
    args0 = (
        vo.map, vo._templates, vo._active_idx, staged_imgs[0],
        vo.R, vo.t, vo.vel_xi,
    )
    cost = track.lower(*args0).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    out = track(*args0)
    jax.block_until_ready(out[0])
    t0 = time.perf_counter()
    R, t, vel = out[0], out[1], out[6]
    for i in range(n):
        out = track(
            vo.map, vo._templates, vo._active_idx,
            staged_imgs[i % len(staged_imgs)],
            R, t, vel,
        )
        R, t, vel = out[0], out[1], out[6]
    jax.block_until_ready(R)
    s_frame = (time.perf_counter() - t0) / n
    out = {
        "on_device_fps": round(1.0 / s_frame, 1),
        "track_kernel_gflops_per_frame": round(flops / 1e9, 3),
    }
    if peak is not None:
        out["mfu_vs_f32_peak"] = round(
            flops / (s_frame * peak["f32_flops"]), 5
        )
        out["hbm_bw_utilization"] = round(
            bytes_acc / (s_frame * peak["hbm_bytes_s"]), 4
        )
    return out


def kernel_silicon(fn, args, peak, n=24, name=""):
    """Cost-analysis + timed burst for one cached engine executable:
    per-call GFLOP, MB accessed, sustained ms/call, and the implied
    MFU / HBM-bandwidth utilization (VERDICT r3 next #4: the track
    kernel was the only one with silicon numbers)."""
    import jax

    cost = fn.lower(*args).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    out = fn(*args)
    jax.block_until_ready(jax.tree.leaves(out)[0])
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(jax.tree.leaves(out)[0])
    s_call = (time.perf_counter() - t0) / n
    out = {
        f"{name}_ms_per_call": round(s_call * 1e3, 3),
        f"{name}_gflops_per_call": round(flops / 1e9, 3),
        f"{name}_mb_accessed": round(bytes_acc / 1e6, 2),
    }
    if peak is not None:
        out[f"{name}_mfu_vs_f32_peak"] = round(
            flops / (s_call * peak["f32_flops"]), 5
        )
        out[f"{name}_hbm_bw_utilization"] = round(
            bytes_acc / (s_call * peak["hbm_bytes_s"]), 4
        )
    return out


def bench_headline(peak, with_device_metrics=True, engine="vo"):
    """Stereo VO frames/s per chip: full KITTI geometry, frames
    pre-staged on device (chip throughput — see the e2e metric for the
    ingestion-included number). Returns (fps, device_metrics_dict) —
    the silicon numbers come from the same engine/executables, so they
    cost one extra burst and zero compiles.

    engine="slam" runs the identical sequence through StereoSLAM (loop
    DB + pose-graph layer on its background worker) — the VERDICT r2
    ask that slam-mode FPS be measured next to the VO headline."""
    from viso_tpu.slam.engine import StereoVO
    from viso_tpu.slam.full import StereoSLAM

    n_frames = 44
    # Must cover init-keyframe, tracking, and keyframe+BA compiles; with
    # the deep stats pipeline the first BA fires at the first scheduled
    # keyframe (kf_max_gap), so cover two keyframe cycles.
    warmup = 12

    cfg = headline_config()
    frames, Rs, ts = headline_sequence(cfg, n_frames)

    vo = StereoVO(cfg) if engine == "vo" else StereoSLAM(cfg)
    # Warmup: trigger every compile path (tracking + keyframe + BA).
    for il, ir in frames[:warmup]:
        vo.process(il, ir)
    if engine == "slam":
        # Drain the loop-layer worker so its first-keyframe compiles
        # (descriptor kernels) complete before the timed region.
        vo.join()

    # Pre-stage the timed frames on device: this measures device
    # throughput (track + keyframe + BA kernels). The `e2e_ingest`
    # metrics report the number WITH decode and upload.
    timed = [vo.to_device(il, ir) for il, ir in frames[warmup:]]
    import jax

    jax.block_until_ready([t[0] for t in timed])
    t0 = time.perf_counter()
    for il, ir in timed:
        vo.process(il, ir)
    # process() keeps results on device; wait for the last frame's pose.
    jax.block_until_ready((vo.R, vo.t))
    if engine == "slam":
        vo.join()   # the loop/pose-graph worker is part of slam's cost
    elapsed = time.perf_counter() - t0
    dev = {}
    if with_device_metrics:
        dev = device_metrics(vo, [il for il, _ in timed], peak)
        # Per-kernel numbers for the OTHER two per-frame executables
        # (keyframe insert + window BA) — same cached executables the
        # bench just ran, so zero extra compiles.
        import jax.numpy as jnp

        from viso_tpu.ops import pyramid as pyr_mod

        il_dev, ir_dev = timed[-1]
        pyr = pyr_mod.build_pyramid(
            il_dev.astype(jnp.float32), cfg.pyramid_levels
        )
        L = cfg.max_landmarks
        kf_args = (
            vo.map, vo.kf_order[-1], jnp.asarray(False), vo.R, vo.t,
            vo.frame_idx, pyr, il_dev, ir_dev,
            jnp.zeros(L, bool), jnp.zeros((L, 2), jnp.float32),
            jnp.asarray(True),
        )
        dev.update(
            kernel_silicon(
                vo._kernels["stereo_kf"], kf_args, peak, name="kf_insert"
            )
        )
        cam_fixed = np.zeros(cfg.max_keyframes, bool)
        cam_fixed[vo.kf_order[0]] = True
        ba_args = (vo.map, jnp.asarray(cam_fixed), vo.kf_order[-1], vo.R, vo.t)
        dev.update(
            kernel_silicon(vo._kernels["ba"], ba_args, peak, name="window_ba")
        )
    from viso_tpu.utils import metrics

    R_est, t_est = vo.trajectory()
    dev["headline_seq_ate_m"] = round(
        float(
            metrics.ate_rmse(
                metrics.camera_centers(R_est, t_est),
                metrics.camera_centers(Rs, ts),
                align=True, with_scale=False,
            )
        ),
        4,
    )
    vo.close()
    return (n_frames - warmup) / elapsed, dev


def bench_ba_iters(peak, C=50, L=4096, iters=10, reps=10):
    """LM iterations/s on a 50-keyframe x 4096-landmark window
    (north-star metric row 3; measures backend/ba.py — the realization
    of the reference's dead BlockSolver<6,3> intent)."""
    from tools.bench_ba import make_problem
    from viso_tpu.backend import ba

    prob = make_problem(C, L)
    params = ba.BAParams(iters=iters, num_fixed=2)
    out, info = ba.solve(prob, params)  # compile
    float(info["final_cost"])
    # Back-to-back dispatches + ONE value readback as the fence.
    t0_ = time.perf_counter()
    for _ in range(reps):
        out, info = ba.solve(prob, params)
    float(info["final_cost"])
    dt = (time.perf_counter() - t0_) / reps
    # Speed-of-light accounting: XLA's own cost analysis of the exact
    # executable gives flops + bytes per solve; divide by measured time
    # to see which wall the solve sits against.
    cost = ba.solve.lower(prob, params).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    silicon = {
        "ba_solve_ms": round(dt * 1e3, 2),
        "ba_gflops_per_solve": round(flops / 1e9, 2),
        "ba_mb_per_solve": round(bytes_acc / 1e6, 1),
    }
    if peak is not None:
        silicon["ba_mfu_vs_f32_peak"] = round(
            flops / (dt * peak["f32_flops"]), 4
        )
        silicon["ba_hbm_bw_utilization"] = round(
            bytes_acc / (dt * peak["hbm_bytes_s"]), 4
        )
    return iters / dt, silicon


def bench_mono(n_frames=500, warmup=60):
    """BASELINE config 1: monocular VO over 500 frames (the reference's
    own modality, /root/reference/src/viso.cpp:7-145). Returns
    (scale-aligned ATE RMSE, frames/s) on a disk-cached synthetic
    corridor at half-KITTI geometry, fed through the native prefetcher.
    VERDICT r3 missing #2: the number existed in tests but was never
    recorded in any BENCH file."""
    import tempfile

    import jax

    from viso_tpu.data import native, png_io, synthetic
    from viso_tpu.geometry import camera
    from viso_tpu.slam.engine import MonocularVO, VOConfig
    from viso_tpu.utils import metrics

    H, W = 184, 616
    root = os.path.join(
        tempfile.gettempdir(),
        f"viso_bench_mono_{os.getuid()}_{H}x{W}x{n_frames}",
    )
    meta = os.path.join(root, "poses.npz")
    intr = camera.Intrinsics.create(
        KITTI_FULL["fx"] / 2, KITTI_FULL["fy"] / 2,
        KITTI_FULL["cx"] / 2, KITTI_FULL["cy"] / 2,
    )
    if os.path.exists(meta):
        d = np.load(meta)
        Rs, ts = d["Rs"], d["ts"]
    else:
        os.makedirs(root, exist_ok=True)
        rng = np.random.default_rng(5)
        scene = synthetic.corridor_scene(rng, tex_size=1024, far_z=90.0)
        # 500 x 0.15 m = 75 m of forward travel, inside far_z.
        Rs, ts = synthetic.forward_trajectory(
            n_frames, step=0.15, yaw_rate=0.002
        )
        for i, (R, t) in enumerate(zip(Rs, ts)):
            p = os.path.join(root, f"L{i:04d}.png")
            if os.path.exists(p):
                continue
            img, _ = scene.render(intr, R, t, H, W)
            png_io.write_gray_png(p, img)
        np.savez(meta, Rs=Rs, ts=ts)
    paths = [os.path.join(root, f"L{i:04d}.png") for i in range(n_frames)]

    cfg = VOConfig(
        height=H, width=W,
        fx=KITTI_FULL["fx"] / 2, fy=KITTI_FULL["fy"] / 2,
        cx=KITTI_FULL["cx"] / 2, cy=KITTI_FULL["cy"] / 2,
        num_features=256, max_landmarks=1024, detect_grid=(4, 8),
        fast_threshold=8.0, **MONO_TUNING,
    )
    vo = MonocularVO(cfg)
    pre = native.Prefetcher(paths, ring=16, threads=3)

    def next_img():
        return vo.to_device(
            np.clip(next(pre), 0, 255).astype(np.uint8)
        )

    nxt = next_img()
    for i in range(warmup):
        cur, nxt = nxt, next_img()
        vo.process(cur)
    t0 = time.perf_counter()
    for i in range(n_frames - warmup):
        cur = nxt
        nxt = next_img() if i < n_frames - warmup - 1 else None
        vo.process(cur)
    jax.block_until_ready((vo.R, vo.t))
    elapsed = time.perf_counter() - t0
    pre.close()
    R_est, t_est = vo.trajectory()
    vo.close()
    c_est = metrics.camera_centers(R_est, t_est)
    c_gt = metrics.camera_centers(Rs, ts)
    # Monocular scale is unobservable: align with scale (config 1).
    ate = metrics.ate_rmse(c_est, c_gt, align=True, with_scale=True)
    # Drift BREAKDOWN (VERDICT r4 #6: record the diagnosis, not just the
    # scalar): per-frame step-scale profile start vs end (mono scale
    # drift), and end-to-end rotation error relative to the first frame
    # (yaw drift) — the two mono failure axes a scale-aligned ATE mixes.
    d_est = np.linalg.norm(np.diff(c_est, axis=0), axis=-1)
    d_gt = np.linalg.norm(np.diff(c_gt[: len(c_est)], axis=0), axis=-1)
    sc = d_est / np.maximum(d_gt, 1e-9)
    sc = sc[d_gt > 1e-6]
    q = len(sc) // 4
    scale_drift = (
        float(np.median(sc[-q:]) / max(np.median(sc[:q]), 1e-9))
        if q >= 8
        else float("nan")
    )
    R_rel_est = R_est[-1] @ R_est[0].T
    R_rel_gt = np.asarray(Rs[len(R_est) - 1]) @ np.asarray(Rs[0]).T
    rot_err = float(
        np.degrees(
            np.arccos(
                np.clip(
                    (np.trace(R_rel_est @ R_rel_gt.T) - 1) / 2, -1, 1
                )
            )
        )
    )
    breakdown = {
        "mono_scale_drift_end_over_start": round(scale_drift, 3),
        "mono_end_rot_err_deg": round(rot_err, 2),
    }
    return float(ate), (n_frames - warmup) / elapsed, breakdown


def bench_mono_slam(n_frames=500, warmup=40):
    """Monocular SLAM with Sim(3) loop closure on the 2-lap orbit room
    (left images of the stereo loop sequence — BASELINE configs 1+4
    joined on the reference's own modality). Records what the r4 test
    asserted but no BENCH file ever measured (VERDICT r4 #2): loops
    closed, raw-odometry ATE vs Sim3-corrected keyframe ATE (both
    scale-aligned), and the e2e FPS.
    """
    import jax

    from viso_tpu.data import native
    from viso_tpu.slam.engine import VOConfig
    from viso_tpu.slam.loop_closure import LoopParams
    from viso_tpu.slam.mono_full import MonoSLAM
    from viso_tpu.utils import metrics

    H, W = 184, 616
    root, Rs, ts = _ensure_png_sequence(H, W, n_frames)
    paths = [os.path.join(root, f"L{i:04d}.png") for i in range(n_frames)]

    cfg = VOConfig(
        height=H, width=W,
        fx=KITTI_FULL["fx"] / 2, fy=KITTI_FULL["fy"] / 2,
        cx=KITTI_FULL["cx"] / 2, cy=KITTI_FULL["cy"] / 2,
        num_features=256, max_landmarks=1024, detect_grid=(4, 8),
        fast_threshold=6.0, **MONO_TUNING,
    )
    slam = MonoSLAM(
        cfg, LoopParams(min_inliers=40, max_correction_m=4.0)
    )
    pre = native.Prefetcher(paths, ring=16, threads=3)

    def next_img():
        return slam.to_device(np.clip(next(pre), 0, 255).astype(np.uint8))

    nxt = next_img()
    for i in range(warmup):
        cur, nxt = nxt, next_img()
        slam.process(cur)
    t0 = time.perf_counter()
    for i in range(n_frames - warmup):
        cur = nxt
        nxt = next_img() if i < n_frames - warmup - 1 else None
        slam.process(cur)
    jax.block_until_ready((slam.R, slam.t))
    elapsed = time.perf_counter() - t0
    pre.close()
    slam.join()
    # Keyframe-level comparison in ONE frame set: raw odometry nodes vs
    # Sim3-corrected nodes against ground truth, both scale-aligned
    # (mono scale is unobservable).
    pg_R, pg_t, pg_frames = slam.graph_trajectory()
    raw_R = np.stack(slam.pg_raw_R)
    raw_t = np.stack(slam.pg_raw_t)
    loops = len(slam.loops)
    dump = os.environ.get("VISO_MONO_SLAM_DUMP")
    if dump:
        np.savez(
            dump, raw_R=raw_R, raw_t=raw_t, pg_R=pg_R, pg_t=pg_t,
            pg_s=np.asarray(slam.pg_s), pg_frames=np.asarray(pg_frames),
            Rs=Rs, ts=ts,
            loop_from=np.asarray([lo["from"] for lo in slam.loops]),
            loop_to=np.asarray([lo["to"] for lo in slam.loops]),
            loop_s=np.asarray([lo["s_rel"] for lo in slam.loops]),
        )
    slam.close()
    fr = np.asarray(pg_frames)
    c_gt = metrics.camera_centers(Rs[fr], ts[fr])
    ate_pg = metrics.ate_rmse(
        metrics.camera_centers(pg_R, pg_t), c_gt,
        align=True, with_scale=True,
    )
    ate_raw = metrics.ate_rmse(
        metrics.camera_centers(raw_R, raw_t), c_gt,
        align=True, with_scale=True,
    )
    return (
        float(ate_pg), float(ate_raw), loops,
        (n_frames - warmup) / elapsed,
    )


def bench_backend_comparison():
    """Photometric vs reprojection window BA on the same sequence
    (tools/bench_backends.py, in this process): ATE + ms/solve per
    backend."""
    from tools import bench_backends

    out = {}
    for r in bench_backends.compare(frames=36):
        b = r["backend"]
        out[f"{b}_ate_m"] = r["ate_rmse_m"]
        out[f"{b}_ba_ms"] = r["ba_ms_per_keyframe"]
    return out


def _ensure_png_sequence(H, W, n_frames):
    """Render (once, disk-cached) a 2-lap orbit loop-closure sequence at
    half-KITTI geometry and write it as 8-bit grayscale PNGs — the input
    for both the long-ATE and the ingestion-included FPS metrics."""
    import tempfile

    from viso_tpu.data import png_io, synthetic
    from viso_tpu.geometry import camera

    root = os.path.join(
        tempfile.gettempdir(),
        f"viso_bench_seq_{os.getuid()}_{H}x{W}x{n_frames}_v2",
    )
    meta = os.path.join(root, "poses.npz")
    if os.path.exists(meta):
        d = np.load(meta)
        return root, d["Rs"], d["ts"]
    os.makedirs(root, exist_ok=True)
    intr = camera.Intrinsics.create(
        KITTI_FULL["fx"] / 2, KITTI_FULL["fy"] / 2,
        KITTI_FULL["cx"] / 2, KITTI_FULL["cy"] / 2,
    )
    rng = np.random.default_rng(11)
    # Walls at 5.5 m with a 2.5 m orbit keep every viewing distance in
    # 3-8 m: strong gradients + healthy stereo disparity all the way
    # around (half=8/radius=3 left an 11 m corner sector where tracking
    # starved).
    scene = synthetic.room_scene(rng, tex_size=768, half=5.5)
    Rs, ts = synthetic.orbit_trajectory(
        n_frames, radius=2.5, total_angle=4 * np.pi
    )
    for i, (R, t) in enumerate(zip(Rs, ts)):
        lp = os.path.join(root, f"L{i:04d}.png")
        rp = os.path.join(root, f"R{i:04d}.png")
        if os.path.exists(lp) and os.path.exists(rp):
            continue  # resumable: an interrupted build keeps its frames
        il, ir, _ = synthetic.make_stereo_pair(
            scene, intr, R, t, H, W, baseline=0.537
        )
        png_io.write_gray_png(lp, il)
        png_io.write_gray_png(rp, ir)
    np.savez(meta, Rs=Rs, ts=ts)
    return root, Rs, ts


def bench_long_slam(n_frames=500, warmup=60, degrade=False):
    """500-frame loop-closure SLAM run fed through the NATIVE ingestion
    path: C++ PNG decode + prefetch ring + uint8 H2D + full engine.

    Returns (ate_rmse_m, loops_closed, e2e_fps) where e2e_fps times
    frames [warmup:] INCLUDING decode and host->device transfer — the
    system number the pre-staged headline metric deliberately excludes.

    degrade=True runs the same sequence through a photometric-nuisance
    model (drifting exposure gain/bias + sensor noise + mild blur) —
    the brightness-constancy stress the clean renders never apply
    (VERDICT r3 next #5).
    """
    import jax

    from viso_tpu.data import native, synthetic
    from viso_tpu.slam.engine import VOConfig
    from viso_tpu.slam.full import StereoSLAM
    from viso_tpu.utils import metrics

    H, W = 184, 616  # divisible by 2^3 for the 4-level pyramid
    root, Rs, ts = _ensure_png_sequence(H, W, n_frames)
    paths = []
    for i in range(n_frames):
        paths.append(os.path.join(root, f"L{i:04d}.png"))
        paths.append(os.path.join(root, f"R{i:04d}.png"))

    cfg = VOConfig(
        height=H, width=W, baseline=0.537,
        fx=KITTI_FULL["fx"] / 2, fy=KITTI_FULL["fy"] / 2,
        cx=KITTI_FULL["cx"] / 2, cy=KITTI_FULL["cy"] / 2,
        num_features=256, max_landmarks=1024, detect_grid=(4, 8),
        # The distant room walls render smoother than the corridor:
        # FAST needs a lower bar to fill the feature budget here.
        fast_threshold=6.0, max_disparity=96,
        stats_max_lag=8, kf_max_gap=8, kf_min_gap=2,
    )
    from viso_tpu.slam.loop_closure import LoopParams

    # Orbit laps in a self-similar room: demand strong loop evidence and
    # bound the implied correction (drift over one lap is ~1-2 m here).
    slam = StereoSLAM(
        cfg, LoopParams(min_inliers=40, max_correction_m=4.0)
    )
    pre = native.Prefetcher(paths, ring=16, threads=3)
    nuis = (
        synthetic.PhotometricNuisance(np.random.default_rng(77))
        if degrade else None
    )

    def next_pair():
        il = next(pre)
        ir = next(pre)
        if nuis is not None:
            # One exposure step per FRAME, applied to both images (a
            # stereo rig shares exposure control); noise per image.
            nuis.step()
            il, ir = nuis.apply(il), nuis.apply(ir)
        # uint8 H2D: 4x less host-to-device traffic than f32; pre-uploaded
        # one frame ahead (to_device) so the transfer overlaps the
        # previous frame's compute instead of serializing with it.
        return slam.to_device(
            np.clip(il, 0, 255).astype(np.uint8),
            np.clip(ir, 0, 255).astype(np.uint8),
        )

    nxt = next_pair()
    for i in range(warmup):
        cur, nxt = nxt, next_pair()
        slam.process(*cur)
    frame_times: list[float] = []
    # Pre-compile the fused loop-detection kernel: the first eligible
    # detection fires ~30 keyframes in (the guard window), INSIDE the
    # timed region — behind an empty compile cache that compile would be
    # billed as frame time.
    import jax.numpy as jnp

    from viso_tpu.slam import loop_closure as lc

    db = slam.loop_db
    lp = db.params
    lc._detect_fused_kernel(
        db.desc[0], db.desc_mask[0],
        jnp.zeros((lp.num_features, 2), jnp.float32),
        db.desc, db.desc_mask, db.points_w_dev, db.points_ok_dev,
        jnp.ones(lp.capacity, bool), slam.intr,
        jnp.asarray(1e-5, jnp.float32),
        jnp.asarray(lp.min_matches, jnp.int32),
        jnp.asarray(lp.min_inliers, jnp.int32),
        jax.random.PRNGKey(0),
    ).block_until_ready()
    t0 = time.perf_counter()
    for i in range(n_frames - warmup):
        cur = nxt
        tf = time.perf_counter()
        # Issue the next pair's H2D before dispatching this frame's
        # compute (last iteration has nothing left to stage).
        nxt = next_pair() if i < n_frames - warmup - 1 else None
        slam.process(*cur)
        frame_times.append(time.perf_counter() - tf)
    jax.block_until_ready((slam.R, slam.t))
    elapsed = time.perf_counter() - t0
    pre.close()
    R_est, t_est = slam.trajectory()
    slam.close()
    c_est = metrics.camera_centers(R_est, t_est)
    c_gt = metrics.camera_centers(Rs, ts)
    ate = metrics.ate_rmse(c_est, c_gt, align=True, with_scale=False)
    # Median per-frame FPS alongside the mean: the median characterizes
    # the steady state without the outlier frames (keyframes, loops).
    med = float(np.median(frame_times)) if frame_times else float("inf")
    fps_pair = ((n_frames - warmup) / elapsed, 1.0 / max(med, 1e-9))
    return float(ate), len(slam.loops), fps_pair


def bench_e2e_fullres(n_frames=44, warmup=12):
    """Ingestion-included stereo VO FPS at FULL KITTI resolution: C++
    PNG decode + prefetch ring + one-frame-ahead uint8 H2D + the same
    engine config as the headline (so its cached executables are
    reused), next to the pre-staged headline."""
    import tempfile

    import jax

    from viso_tpu.data import native, png_io
    from viso_tpu.slam.engine import StereoVO

    root = os.path.join(
        tempfile.gettempdir(), f"viso_bench_fullres_{os.getuid()}_{n_frames}"
    )
    os.makedirs(root, exist_ok=True)
    cfg = headline_config()
    done = os.path.join(root, "done")
    if not os.path.exists(done):
        frames, _, _ = headline_sequence(cfg, n_frames)
        for i, (il, ir) in enumerate(frames):
            png_io.write_gray_png(os.path.join(root, f"L{i:04d}.png"), il)
            png_io.write_gray_png(os.path.join(root, f"R{i:04d}.png"), ir)
        with open(done, "w") as f:
            f.write("ok")
    paths = []
    for i in range(n_frames):
        paths.append(os.path.join(root, f"L{i:04d}.png"))
        paths.append(os.path.join(root, f"R{i:04d}.png"))

    vo = StereoVO(cfg)
    pre = native.Prefetcher(paths, ring=8, threads=3)

    def next_pair():
        il = next(pre)
        ir = next(pre)
        return vo.to_device(
            np.clip(il, 0, 255).astype(np.uint8),
            np.clip(ir, 0, 255).astype(np.uint8),
        )

    nxt = next_pair()
    for i in range(warmup):
        cur, nxt = nxt, next_pair()
        vo.process(*cur)
    t0 = time.perf_counter()
    for i in range(n_frames - warmup):
        cur = nxt
        nxt = next_pair() if i < n_frames - warmup - 1 else None
        vo.process(*cur)
    jax.block_until_ready((vo.R, vo.t))
    elapsed = time.perf_counter() - t0
    pre.close()
    vo.close()
    return (n_frames - warmup) / elapsed


def main():
    import jax

    from viso_tpu.utils import compile_cache
    from viso_tpu.utils import device as device_mod

    compile_cache.enable()
    devices = jax.devices()
    cpu_rehearsal = os.environ.get("JAX_PLATFORMS") == "cpu"
    if not cpu_rehearsal:
        device_mod.require_gpu(devices[0])
    device = device_mod.describe(devices)
    peak = None if cpu_rehearsal else peaks(devices[0].device_kind)

    # Stages run in IMPORTANCE order under a wall-clock budget: if the
    # budget is hit, remaining stages are recorded as skipped and the
    # JSON line still prints — an outside timeout must never lose the
    # whole record.
    t_start = time.perf_counter()
    budget_s = float(os.environ.get("VISO_BENCH_BUDGET_S", "2300"))
    stage_s: dict = {}

    # Device metrics (on-device rate, utilization shares) only from a GPU.
    fps, dev = bench_headline(peak, with_device_metrics=peak is not None)
    extra = dict(dev)
    stage_s["headline"] = round(time.perf_counter() - t_start, 1)

    def run_stage(name, fn):
        """Run one optional stage with error isolation + the budget."""
        if time.perf_counter() - t_start > budget_s:
            extra[name] = "skipped: bench time budget"
            return
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — never lose the headline
            extra[name] = f"error: {e}"
        stage_s[name] = round(time.perf_counter() - t0, 1)

    def _slam_fps():
        slam_fps, _ = bench_headline(
            peak, with_device_metrics=False, engine="slam"
        )
        extra["stereo_slam_fps_full_res"] = round(slam_fps, 2)

    def _ba():
        iters_s, ba_silicon = bench_ba_iters(peak)
        extra["ba_iters_per_s_50kf_4096lm"] = round(iters_s, 2)
        extra.update(ba_silicon)

    def _long_slam():
        ate, loops, e2e_fps = bench_long_slam()
        extra["ate_rmse_m_500f_loop_slam"] = round(ate, 4)
        extra["loops_closed_500f"] = loops
        extra["e2e_ingest_fps_500f_median"] = round(e2e_fps[1], 2)
        # Includes PNG decode + H2D (one frame ahead, overlapped).
        extra["e2e_ingest_fps_500f_half_res"] = round(e2e_fps[0], 2)

    def _degraded():
        ate_d, loops_d, _ = bench_long_slam(degrade=True)
        extra["ate_rmse_m_500f_degraded"] = round(ate_d, 4)
        extra["loops_closed_500f_degraded"] = loops_d

    def _mono():
        mono_ate, mono_fps, breakdown = bench_mono()
        extra["mono_ate_rmse_m_500f"] = round(mono_ate, 4)
        extra["mono_fps_500f"] = round(mono_fps, 2)
        extra.update(breakdown)

    def _mono_slam():
        ate_pg, ate_raw, loops, ms_fps = bench_mono_slam()
        extra["mono_slam_ate_m"] = round(ate_pg, 4)
        extra["mono_slam_ate_raw_m"] = round(ate_raw, 4)
        extra["mono_slam_loops"] = loops
        extra["mono_slam_fps"] = round(ms_fps, 2)

    def _fullres():
        extra["e2e_ingest_fps_full_res"] = round(bench_e2e_fullres(), 2)

    if os.environ.get("VISO_BENCH_QUICK") != "1":
        run_stage("stereo_slam_fps_full_res", _slam_fps)
        run_stage("ba_iters_per_s_50kf_4096lm", _ba)
        run_stage("long_slam", _long_slam)
        run_stage("mono_slam_500f", _mono_slam)
        run_stage("degraded_500f", _degraded)
        run_stage("mono_500f", _mono)
        run_stage("backend_comparison",
                  lambda: extra.update(bench_backend_comparison()))
        run_stage("e2e_ingest_fps_full_res", _fullres)
    extra["bench_stage_s"] = stage_s

    # Headline (VERDICT r4 #8): the SUSTAINED, ingestion-included
    # 500-frame SLAM FPS (PNG decode + H2D + tracking + loop closure +
    # pose graph) is the system number; the 32-frame pre-staged burst is
    # kept in extra as the chip-throughput figure. Falls back to the
    # burst when the long stage didn't run (QUICK mode / budget hit).
    extra["burst_prestaged_fps_full_res"] = round(fps, 3)
    e2e = extra.get("e2e_ingest_fps_500f_half_res")
    if isinstance(e2e, (int, float)):
        metric = "slam_e2e_fps_per_chip_500f"
        value = float(e2e)
    else:
        metric = "stereo_vo_fps_per_chip"
        value = round(fps, 3)
    print(
        json.dumps(
            {
                "metric": metric,
                "value": value,
                "unit": "frames/s",
                "vs_baseline": round(value / 10.0, 3),
                "device": device,
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
