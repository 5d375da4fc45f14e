"""Smoke check of the VO / SLAM engines on an NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: distributed window BA

Everything runs in ONE process (a JAX process reserves most of a card's
memory when it starts), phase after phase. The first failure ends the run
with a non-zero exit code and no result line. Phases on one card:

  device   the first JAX device must be a GPU (no CPU fallback); prints its
           kind, the device count, nvidia-smi's name and power limit, and
           the compilation-cache directory;
  native   builds native/ (the C++ PNG decoder) and reports whether it
           loaded;
  stereo   StereoSLAM (loop layer on) at the benchmark's headline width
           (bench.headline_config: 1240x376, 512 features, 2048 landmark
           slots, 6x12 detect grid, 128 px disparity) over a seeded
           synthetic KITTI-like drive: finite poses, >= 3 keyframes,
           window BA, ATE under a bound;
  mono     MonocularVO at the same width with its default photometric
           window BA: init, >= 1 window-BA solve, finite poses;
  cli      viso_tpu.run.main on the synthetic dataset in slam mode;
  kernels  each kernel run jitted on the GPU and on the CPU in this process
           at real widths, compared (window extraction against numpy).

Each measured line is labelled with the card's name and power limit. The
last line of stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import tempfile
import threading
import time

import numpy as np

STEREO_FRAMES = 44
# Bound on the stereo phase's ATE over STEREO_FRAMES frames, in metres,
# for both SE(3)- and Sim(3)-aligned ATE. A CPU run of this phase at the
# same frame count (JAX_PLATFORMS=cpu, same seed, 16 cores) read 0.0450 m
# SE(3)-aligned / 0.0403 m Sim(3)-aligned with 9 keyframes; the first GPU
# run read 0.0284 m with 15. Keyframe timing follows when stats
# readbacks land, which differs between devices and runs, so the bound
# is ~2.2x the CPU reading.
ATE_BOUND_M = 0.10

# Enough frames after the two-view init for several keyframes
# (kf_max_gap 8), so window BA runs more than once.
MONO_FRAMES = 56

# GPU-vs-CPU tolerances. The package keeps f32 matmuls at full f32
# (viso_tpu/__init__.py), so the GPU differs from the CPU only by the
# order of f32 sums (~1e-7 relative per reduction).
# Window extraction copies pixels: exact.
# Direct tracker (__graft_entry__.entry: GN on random-noise images, an
# ill-conditioned problem): 1e-2 gray levels of input noise moves the CPU
# pose by 4e-4 (rotation element) / 5e-3 m; reordered sums perturb far
# less than that.
DIRECT_TOL_R = 1e-3
DIRECT_TOL_T = 1e-2
# Window BA, 50 cameras x 4096 landmarks, 10 LM iterations: the cost is a
# sum over ~60k residuals and the steps come from a 300x300 Cholesky
# solve, so the final cost may differ in its leading f32 digits' noise.
# Translations lie in a nearly flat valley: on the CPU, 1e-5 noise on the
# normalized observations (~0.007 px) moves them by 1.4e-4 m at equal
# cost, and the GPU's summation order depends on the compiled executable
# (a cold compile read 3.8e-6 m, executables from the compile cache
# 5.4e-4 m). The bound is 2e-4 of the trajectory's 24 m extent.
BA_TOL_COST_REL = 1e-3
BA_TOL_R = 1e-4
BA_TOL_T = 5e-3
# Photometric BA at the engine's level-1 width: residuals are intensity
# differences of bilinear samples (0-255), 8 LM iterations.
PBA_TOL_COST_REL = 1e-3
PBA_TOL_R = 1e-4
PBA_TOL_T = 1e-3


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, summed."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        self.total = 0.0
        self._lock = threading.Lock()
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kw):
        if event in self.EVENTS:
            with self._lock:
                self.total += duration


def check_device(dev):
    """The device a chip run measures on: a GPU, or an error."""
    from viso_tpu.utils import device as device_mod

    return device_mod.require_gpu(dev)


def _on(dev, fn, *args):
    """Run jitted `fn` with its arguments committed to `dev`; host result."""
    import jax

    args = jax.device_put(args, dev)
    with jax.default_device(dev):
        out = fn(*args)
    return jax.tree.map(np.asarray, out)


def _rot_t_diff(Ra, ta, Rb, tb):
    return (
        float(np.abs(np.asarray(Ra) - np.asarray(Rb)).max()),
        float(np.abs(np.asarray(ta) - np.asarray(tb)).max()),
    )


def _require(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# Engines at full width
# ---------------------------------------------------------------------------


def run_stereo_slam(cfg, n_frames):
    """StereoSLAM over the headline sequence; returns a summary dict."""
    import bench
    from viso_tpu.slam.full import StereoSLAM
    from viso_tpu.utils import metrics

    frames, Rs, ts = bench.headline_sequence(cfg, n_frames)
    vo = StereoSLAM(cfg)
    try:
        for il, ir in frames:
            vo.process(il, ir)
        R_est, t_est = vo.trajectory()
        ba_ran = "ba" in vo._kernels
        loops = len(vo.loops)
    finally:
        vo.close()
    c_est = metrics.camera_centers(R_est, t_est)
    c_gt = metrics.camera_centers(Rs, ts)
    finite = bool(np.isfinite(R_est).all() and np.isfinite(t_est).all())
    return {
        "finite": finite,
        "keyframes": int(sum(r.is_keyframe for r in vo.results)),
        "window_ba": ba_ran,
        "loops": loops,
        "ate_se3_m": float(
            metrics.ate_rmse(c_est, c_gt, align=True, with_scale=False)
        ),
        "ate_sim3_m": float(
            metrics.ate_rmse(c_est, c_gt, align=True, with_scale=True)
        ),
    }


def mono_config():
    """The headline width with the monocular cells' tuning
    (bench.MONO_TUNING)."""
    import bench

    return bench.headline_config(fast_threshold=8.0, **bench.MONO_TUNING)


def run_mono(cfg, n_frames, seed=5):
    """MonocularVO (photometric window BA) on a forward corridor drive."""
    from viso_tpu.data import synthetic
    from viso_tpu.slam.engine import MonocularVO

    rng = np.random.default_rng(seed)
    scene = synthetic.corridor_scene(rng, tex_size=1024, far_z=90.0)
    Rs, ts = synthetic.forward_trajectory(n_frames, step=0.15, yaw_rate=0.002)
    intr = cfg.intrinsics()
    vo = MonocularVO(cfg)
    ba_solves = [0]
    run_ba = vo._run_window_ba

    def counted(fixed_slots):
        ba_solves[0] += 1
        return run_ba(fixed_slots)

    vo._run_window_ba = counted
    try:
        for R, t in zip(Rs, ts):
            img, _ = scene.render(intr, R, t, cfg.height, cfg.width)
            vo.process(img)
        R_est, t_est = vo.trajectory()
        backend = vo._ba_backend()
    finally:
        vo.close()
    return {
        "initialized": any(r.state == "tracking" for r in vo.results),
        "finite": bool(np.isfinite(R_est).all() and np.isfinite(t_est).all()),
        "keyframes": int(sum(r.is_keyframe for r in vo.results)),
        "ba_solves": ba_solves[0],
        "ba_backend": backend,
    }


# ---------------------------------------------------------------------------
# Kernels on the GPU against the plain reference
# ---------------------------------------------------------------------------

# Window sizes the engine extracts at full width: direct (10, 16, 24),
# lk (24), align (16), stereo left windows (12), descriptors (34),
# photometric BA (16); the stereo matcher's right strips are 12 x 140.
EXTRACT_WINS = (10, 12, 16, 24, 34)
STRIP_HW = (12, 140)


def numpy_windows(img, centers, win):
    """Reference window extraction: clipped origins, plain slicing."""
    H, W = img.shape[-2:]
    base = np.floor(centers).astype(np.int32) - win // 2
    base = np.clip(base, 0, [W - win, H - win])
    return base, [img[..., y:y + win, x:x + win] for x, y in base]


def check_extraction(devices, H=376, W=1240, seed=0):
    """Window extraction on each device equals numpy slicing, exactly.
    Returns the number of windows compared."""
    import jax

    from viso_tpu.geometry import sampling
    from viso_tpu.ops import stereo

    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (3, H, W)).astype(np.float32)
    h, w = STRIP_HW
    strips = jax.jit(functools.partial(stereo.scanline_strips, h=h, w=w))
    compared = 0
    for n in (512, 2048):
        centers = np.stack(
            [rng.uniform(-4, W + 4, n), rng.uniform(-4, H + 4, n)], -1
        ).astype(np.float32)
        k = rng.integers(0, 3, n).astype(np.int32)
        for win in EXTRACT_WINS:
            ext = jax.jit(functools.partial(sampling.extract_windows, win=win))
            ext_idx = jax.jit(
                functools.partial(sampling.extract_windows_indexed, win=win)
            )
            base, ref = numpy_windows(imgs[0], centers, win)
            ref = np.stack(ref)
            base_i, ref_i = numpy_windows(imgs, centers, win)
            ref_i = np.stack([w[ki] for w, ki in zip(ref_i, k)])
            for dev in devices:
                got, got_base = _on(dev, ext, imgs[0], centers)
                _require(
                    np.array_equal(got_base, base) and np.array_equal(got, ref),
                    f"extract_windows n={n} win={win} differs on {dev}",
                )
                got, got_base = _on(dev, ext_idx, imgs, k, centers)
                _require(
                    np.array_equal(got_base, base_i)
                    and np.array_equal(got, ref_i),
                    f"extract_windows_indexed n={n} win={win} differs on {dev}",
                )
            compared += 2 * n
        bx = rng.integers(0, W - w + 1, n).astype(np.int32)
        by = rng.integers(0, H - h + 1, n).astype(np.int32)
        ref = np.stack([imgs[1, y:y + h, x:x + w] for x, y in zip(bx, by)])
        for dev in devices:
            got = _on(dev, strips, imgs[1], bx, by)
            _require(
                np.array_equal(got, ref),
                f"stereo scanline strips n={n} differ on {dev}",
            )
        compared += n
    return compared


def check_direct(gpu, cpu):
    """The direct tracker (the driver's entry point) on both devices."""
    import jax

    import __graft_entry__

    fn, args = __graft_entry__.entry()
    args = jax.tree.map(np.asarray, args)
    step = jax.jit(fn)
    Rg, tg, cg = _on(gpu, step, *args)
    Rc, tc, cc = _on(cpu, step, *args)
    dR, dt = _rot_t_diff(Rg, tg, Rc, tc)
    _require(np.isfinite(Rg).all() and np.isfinite(tg).all(),
             "direct tracker: non-finite pose on the GPU")
    _require(dR <= DIRECT_TOL_R and dt <= DIRECT_TOL_T,
             f"direct tracker: GPU-vs-CPU |dR| {dR:.3g}, |dt| {dt:.3g} m")
    return {"dR": dR, "dt_m": dt, "cost_gpu": float(cg), "cost_cpu": float(cc)}


def check_window_ba(gpu, cpu):
    """One window BA solve, 50 keyframes x 4096 landmarks
    (tools/bench_ba.py's problem), on both devices."""
    from tools.bench_ba import make_problem
    from viso_tpu.backend import ba

    prob = make_problem(50, 4096)
    params = ba.BAParams(iters=10, num_fixed=2)

    def solve(p):
        out, info = ba.solve(p, params)
        return out.R, out.t, info["final_cost"], info["initial_cost"]

    Rg, tg, cg, c0 = _on(gpu, solve, prob)
    Rc, tc, cc, _ = _on(cpu, solve, prob)
    dR, dt = _rot_t_diff(Rg, tg, Rc, tc)
    rel = abs(float(cg) - float(cc)) / max(abs(float(cc)), 1e-30)
    _require(np.isfinite(cg) and float(cg) < float(c0),
             f"window BA on the GPU did not descend: {c0} -> {cg}")
    _require(rel <= BA_TOL_COST_REL and dR <= BA_TOL_R and dt <= BA_TOL_T,
             f"window BA: GPU-vs-CPU cost rel {rel:.3g}, |dR| {dR:.3g}, "
             f"|dt| {dt:.3g} m")
    return {"cost_gpu": float(cg), "cost_cpu": float(cc), "cost_rel": rel,
            "dR": dR, "dt_m": dt}


def photo_ba_problem(C=8, L=2048, H=188, W=620, seed=0):
    """Photometric BA window at the engine's widths (8 keyframe slots,
    2048 landmark slots, pyramid level 1 of a 1240x376 frame) on a
    textured fronto-parallel plane seen under lateral motion, with
    perturbed poses and points. Host arrays; returns (problem, intr)."""
    import jax.numpy as jnp

    from viso_tpu.backend import ba_photometric as pba
    from viso_tpu.data import synthetic
    from viso_tpu.geometry import camera, se3

    rng = np.random.default_rng(seed)
    intr = camera.Intrinsics.create(359.428, 359.428, 303.0964, 92.1079)
    scene = synthetic.PlaneScene()
    scene.planes = [
        synthetic.frontal_plane(
            synthetic.smooth_texture(rng, 1024, 1024), z=8.0, tex_scale=60.0
        )
    ]
    Rs = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    ts = np.stack(
        [np.array([-0.2 * c, 0.02 * c, 0.0], np.float32) for c in range(C)]
    )
    images = np.stack(
        [scene.render(intr, Rs[c], ts[c], H, W)[0] for c in range(C)]
    )
    anchor = rng.integers(0, C, L).astype(np.int32)
    uv = np.stack(
        [rng.uniform(12, W - 12, L), rng.uniform(12, H - 12, L)], -1
    ).astype(np.float32)
    pts_w = np.zeros((L, 3), np.float32)
    for c in range(C):
        sel = anchor == c
        depth = scene.depth_at(intr, Rs[c], ts[c], uv[sel]).astype(np.float32)
        p_cam = np.asarray(
            camera.backproject(jnp.asarray(uv[sel]), jnp.asarray(depth), intr)
        )
        pts_w[sel] = p_cam - ts[c]          # R = I: world = cam - t
    good = np.isfinite(pts_w).all(axis=1)
    pts_w[~good] = 0.0
    template = np.asarray(pba.make_template(
        jnp.asarray(images), jnp.asarray(anchor), jnp.asarray(pts_w),
        jnp.asarray(Rs), jnp.asarray(ts), intr,
    ))
    R_p, t_p = Rs.copy(), ts.copy()
    for c in range(2, C):
        dR, dt = se3.se3_exp(
            jnp.asarray(rng.normal(0, 0.003, 6).astype(np.float32))
        )
        R_p[c] = np.asarray(dR) @ R_p[c]
        t_p[c] = np.asarray(dR) @ t_p[c] + np.asarray(dt)
    prob = pba.PhotoBAProblem(
        R=R_p, t=t_p,
        points=pts_w + rng.normal(0, 0.01, pts_w.shape).astype(np.float32),
        images=images, template=template, anchor_idx=anchor,
        obs_mask=np.ones((C, L), bool) & good[None, :],
        cam_mask=np.ones(C, bool), point_mask=good,
    )
    return prob, intr


def check_photo_ba(gpu, cpu):
    """One photometric BA solve (the mono engine's window BA) on both
    devices."""
    from viso_tpu.backend import ba_photometric as pba

    prob, intr = photo_ba_problem()
    params = pba.PhotoBAParams(iters=8, num_fixed=2)

    def solve(p):
        out, info = pba.solve(p, intr, params)
        return out.R, out.t, info["final_cost"], info["initial_cost"]

    Rg, tg, cg, c0 = _on(gpu, solve, prob)
    Rc, tc, cc, _ = _on(cpu, solve, prob)
    dR, dt = _rot_t_diff(Rg, tg, Rc, tc)
    rel = abs(float(cg) - float(cc)) / max(abs(float(cc)), 1e-30)
    _require(np.isfinite(cg) and float(cg) < float(c0),
             f"photometric BA on the GPU did not descend: {c0} -> {cg}")
    _require(rel <= PBA_TOL_COST_REL and dR <= PBA_TOL_R and dt <= PBA_TOL_T,
             f"photometric BA: GPU-vs-CPU cost rel {rel:.3g}, |dR| {dR:.3g}, "
             f"|dt| {dt:.3g} m")
    return {"cost_gpu": float(cg), "cost_cpu": float(cc), "cost_rel": rel,
            "dR": dR, "dt_m": dt}


# ---------------------------------------------------------------------------
# Four cards: the distributed window BA
# ---------------------------------------------------------------------------


def run_distributed(cfg, n_frames, n_dev):
    """The stereo engine at `cfg` with its window BA sharded over `n_dev`
    devices and on one device, on the same frames. Returns (max camera
    center difference in metres, shardings seen by the BA solver).

    Both runs consume their stats on the deterministic schedule, so
    keyframe decisions do not depend on when a readback lands and the
    two trajectories differ only by the BA's reduction order."""
    import bench
    from viso_tpu.parallel import dist_ba
    from viso_tpu.slam.engine import StereoVO
    from viso_tpu.utils import metrics

    frames, _, _ = bench.headline_sequence(cfg, n_frames)
    seen = []
    make_solver = dist_ba.make_sharded_solver

    def recording_solver(mesh, params):
        solver = make_solver(mesh, params)

        def solve(prob):
            seen.append({
                name: len(getattr(prob, name).sharding.device_set)
                for name in ("points", "obs_uv", "obs_mask", "point_mask")
            })
            return solver(prob)

        return solve

    centers = {}
    dist_ba.make_sharded_solver = recording_solver
    try:
        for dist in (True, False):
            vo = StereoVO(dataclasses.replace(
                cfg, distribute_ba=dist, mesh_devices=n_dev if dist else 0,
                stats_deterministic=True,
            ))
            try:
                for il, ir in frames:
                    vo.process(il, ir)
                R_est, t_est = vo.trajectory()
                _require("ba" in vo._kernels, "window BA never ran")
            finally:
                vo.close()
            centers[dist] = metrics.camera_centers(R_est, t_est)
    finally:
        dist_ba.make_sharded_solver = make_solver
    diff = float(np.abs(centers[True] - centers[False]).max())
    return diff, seen


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed window BA on 4 cards")
    args = ap.parse_args(argv)

    import jax

    from viso_tpu.utils import compile_cache
    from viso_tpu.utils import device as device_mod

    devices = jax.devices()
    gpu = check_device(devices[0])
    card = device_mod.nvidia_smi_name_power()
    print(f"device: platform {gpu.platform}, kind {gpu.device_kind}, "
          f"count {len(devices)}")
    print(f"nvidia-smi: {card}")
    print(f"compile cache: {compile_cache.enable()}")
    clock = CompileClock()
    label = f"[{card}]"

    def phase(name, fn):
        c0 = clock.total
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        peak = gpu.memory_stats()["peak_bytes_in_use"]
        print(f"{label} {name}: wall {wall:.2f} s, compile "
              f"{clock.total - c0:.2f} s, peak device memory "
              f"{peak / 2**20:.1f} MiB")
        return out

    import bench

    if args.four_cards:
        n_dev = 4
        _require(len(devices) >= n_dev,
                 f"--four-cards needs 4 devices, JAX sees {len(devices)}")
        diff, seen = phase(
            "distributed stereo VO (4 cards) + single-device reference",
            lambda: run_distributed(bench.headline_config(), 24, n_dev),
        )
        _require(seen, "the sharded BA solver was never called")
        _require(all(v == n_dev for s in seen for v in s.values()),
                 f"BA inputs not sharded over {n_dev} devices: {seen[:2]}")
        print(f"{label} distributed BA: {len(seen)} sharded solves, inputs "
              f"over {n_dev} devices; max camera-center difference vs one "
              f"device {diff:.6f} m (bound 0.05 m)")
        _require(diff < 0.05, f"distributed trajectory differs by {diff} m")
    else:
        from viso_tpu.data import native

        # Reported, not required: no phase below reads image files.
        try:
            native.require()
            print("native: libviso_native built and loaded")
        except RuntimeError as e:
            print(f"native: NOT loaded: {e}")

        cfg = bench.headline_config()
        s = phase(f"stereo SLAM {cfg.width}x{cfg.height}, {STEREO_FRAMES} "
                  "frames", lambda: run_stereo_slam(cfg, STEREO_FRAMES))
        print(f"{label} stereo SLAM: keyframes {s['keyframes']}, window BA "
              f"{s['window_ba']}, loops {s['loops']}, ATE SE(3)-aligned "
              f"{s['ate_se3_m']:.4f} m, Sim(3)-aligned {s['ate_sim3_m']:.4f} m "
              f"(bound {ATE_BOUND_M} m)")
        _require(s["finite"], "stereo SLAM: non-finite poses")
        _require(s["keyframes"] >= 3, f"stereo SLAM: {s['keyframes']} keyframes")
        _require(s["window_ba"], "stereo SLAM: window BA never ran")
        _require(max(s["ate_se3_m"], s["ate_sim3_m"]) <= ATE_BOUND_M,
                 "stereo SLAM: ATE above the bound")

        mcfg = mono_config()
        m = phase(f"mono VO {mcfg.width}x{mcfg.height}, {MONO_FRAMES} frames",
                  lambda: run_mono(mcfg, MONO_FRAMES))
        print(f"{label} mono VO: initialized {m['initialized']}, keyframes "
              f"{m['keyframes']}, window-BA solves {m['ba_solves']} "
              f"({m['ba_backend']})")
        _require(m["initialized"], "mono VO never initialized")
        _require(m["finite"], "mono VO: non-finite poses")
        _require(m["ba_solves"] >= 1, "mono VO: no window-BA solve")

        def cli():
            from viso_tpu import run

            with tempfile.TemporaryDirectory() as out:
                summary = run.main(["--dataset", "synthetic", "--mode", "slam",
                                    "--max-frames", "14", "--out-dir", out])
                for f in ("summary.json", "trajectory.txt"):
                    _require(os.path.exists(os.path.join(out, f)),
                             f"cli: {f} not written")
            return summary

        summary = phase("cli (run.main, synthetic slam, 14 frames)", cli)
        print(f"{label} cli: ATE {summary['ate_rmse_m']:.4f} m")

        cpu = jax.devices("cpu")[0]
        n = phase("kernels: window extraction GPU and CPU vs numpy",
                  lambda: check_extraction((gpu, cpu)))
        print(f"{label} window extraction: {n} windows per device, "
              "exact on GPU and CPU")
        for name, check in (("direct tracker", check_direct),
                            ("window BA 50x4096", check_window_ba),
                            ("photometric BA", check_photo_ba)):
            r = phase(f"kernels: {name} GPU vs CPU",
                      lambda check=check: check(gpu, cpu))
            print(f"{label} {name} GPU-vs-CPU: "
                  + ", ".join(f"{k} {v:.6g}" for k, v in r.items()))

    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
