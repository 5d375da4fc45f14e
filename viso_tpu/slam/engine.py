"""Visual-odometry / SLAM engines: the per-frame state machine.

Replacement for the reference's `Viso` class
(`/root/reference/include/viso.h`, `src/viso.cpp:7-145`): the
kInitialization / kRunning state machine (viso.h:13-17) with FAST
re-seeding every `reinitialize_after` frames (viso.cpp:14,100-108), LK
bootstrap tracking, two-view initialization with the >50-track / >90%%
inlier acceptance gate (viso.cpp:76-77), direct photometric tracking
(viso.cpp:113-121) and LK map-to-frame alignment (viso.cpp:768-843) —
plus everything the reference only intended: keyframe management, new
landmark triangulation, sliding-window BA (bundle_adjuster.h), stereo,
and PnP (BASELINE.json configs 2-4).

Architecture: frame-rate decisions (state transitions, keyframe policy)
are host-side Python — they are per-frame scalars, exactly like the
reference's control flow — while every per-feature / per-pixel
computation is a jitted static-shape kernel from viso_tpu.ops /
viso_tpu.backend. All kernel inputs keep identical shapes across frames,
so each kernel traces exactly once per run.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from viso_tpu.backend import ba
from viso_tpu.geometry import camera as cam_mod
from viso_tpu.geometry import se3
from viso_tpu.mapping import map_state
from viso_tpu.ops import align, direct, fast, lk, pnp, pyramid, stereo, twoview


@dataclass
class VOConfig:
    # Image geometry
    height: int = 376
    width: int = 1241
    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    baseline: float = 0.537   # stereo baseline (m), KITTI default

    # Capacities (static shapes)
    max_keyframes: int = 8
    max_landmarks: int = 2048
    num_features: int = 512   # detected per keyframe
    pyramid_levels: int = 4

    # Detection
    fast_threshold: float = 25.0
    detect_grid: tuple = (6, 12)
    # Multi-scale detection: run FAST on this many pyramid levels with
    # per-level threshold fast_threshold/2^level, finest level first
    # (ops/fast.detect_grid_pyramid). Close-range surfaces magnify
    # texture until level-0 FAST finds nothing; coarse levels keep those
    # sectors trackable. 1 = classic single-scale.
    detect_levels: int = 3

    # Initialization (reference gates, viso.h:20-26 / viso.cpp:76-77)
    reinitialize_after: int = 10
    min_init_tracks: int = 50
    min_init_inlier_ratio: float = 0.9
    init_projection_error_px: float = 1.0
    init_parallax_deg: float = 60.0
    disparity_squared_thresh: float = 15.0**2
    # Rotation-compensated baseline gate: accept the two-view bootstrap
    # only once the median TRIANGULATED parallax of its inliers reaches
    # this many degrees. The reference's disparity gate (viso.cpp:
    # 197-218) reads raw flow, which rotation inflates — on a rotating
    # trajectory it passes at near-zero baseline, and a map triangulated
    # at <1.5 deg parallax has depth noise that destabilizes every pose
    # solve of the young segment (measured: a post-re-init segment's
    # scale collapsed 4x within 8 frames from a 1-frame-baseline
    # bootstrap; see tools/diag_mono_seam.py).
    init_min_parallax_deg: float = 1.5
    # Per-landmark parallax floor for NEW-landmark triangulation at
    # mono keyframes (see _build_mono_kf_kernel): below this the depth
    # is noise, not measurement. Degrees.
    min_triangulation_parallax_deg: float = 0.5

    # Tracking
    ransac_threshold_px: float = 2.0
    min_tracked_points: int = 30
    # Direct-tracking GN iterations per pyramid level. The reference
    # caps at 100 with early stop (viso.cpp:666); with the constant-
    # velocity warm start and coarse-to-fine cascade, 6 measures
    # accuracy-equivalent to 10 on both the forward-corridor and the
    # 2-lap orbit benchmarks while cutting on-device frame time ~18%
    # (189 -> 231 FPS) — this is the main device-time dial of the
    # per-frame path (~42% of the track kernel).
    direct_iters: int = 6
    # 2-DoF LK alignment iterations per level (ops/align.py, ~24% of the
    # track kernel). The warm start is the converged direct pose, so the
    # refinement is a <=4 px correction; 5 measures within noise of 10
    # on the corridor and 2-lap-orbit benchmarks (on-device 229 -> 269
    # FPS with direct_iters=6).
    align_iters: int = 5
    # Active tracking subset: the per-frame kernels run on this many
    # landmark slots (valid + recently-tracked first) instead of the full
    # capacity — tracking cost scales with this, not max_landmarks.
    track_landmarks: int = 1024
    # Lost-tracking handling (generalizes the reference's
    # reinitialize_after re-seeding, viso.h:20).
    min_lost_points: int = 8
    lost_reinit_after: int = 3
    max_step_translation: float = 3.0   # per-frame motion-model clamps
    max_step_rotation: float = 0.5
    # ACCELERATION gate on the refined solve: a step deviating from the
    # filtered velocity by more than this (rad / m per frame) is
    # physically absurd for any platform with inertia and marks a
    # degenerate solve, not motion (measured on the mono corridor: ONE
    # garbage solve at 31 tracked landmarks during an occlusion pass
    # acquired 12.8 deg of rotation error in a single step — the whole
    # run's rotation budget). Rejected solves hold the motion model and
    # report a lost frame so recovery triggers promptly.
    max_accel_rotation: float = 0.2
    max_accel_translation: float = 1.0
    # Window-BA adoption bounds (tighter than the per-frame gate): BA
    # polishes a pose tracking JUST estimated, so a healthy shift is
    # sub-degree / centimeters; a window poisoned by an occlusion
    # crisis can "converge" several degrees away per keyframe and still
    # slip under the per-frame acceleration gate. Rejection keeps the
    # pre-BA map + pose (no refinement that keyframe — safe).
    max_ba_shift_rotation: float = 0.05
    max_ba_shift_translation: float = 0.5

    # Keyframe policy
    kf_min_gap: int = 3
    kf_max_gap: int = 20
    kf_min_visible_frac: float = 0.6
    # On-device tracking stats are fetched by a background reader
    # thread (np.asarray off the dispatch thread); the frame loop polls
    # the completed fetches and consumes the newest one, so it never
    # blocks on a device->host readback. It force-joins the oldest
    # fetch only when more than stats_max_lag are in flight, bounding
    # decision staleness; keyframe / lost decisions additionally
    # ignore samples older than the newest keyframe, so
    # staleness can exceed kf_min_gap without re-triggering inserts.
    stats_max_lag: int = 2
    # Hard bound on stats staleness IN FRAMES: the frame loop force-joins
    # the oldest in-flight fetch once it is this many frames old, which
    # also backpressures dispatch when it outruns device compute.
    # 0 = max(2, stats_max_lag). This is the throughput/reactivity dial:
    # a fetch lands naturally in ~readback_latency/frame_time frames, so
    # hard bounds above that never block and keep the dispatch loop at
    # device speed, while lower values trade blocked readback time for
    # faster keyframe/lost reactions.
    stats_hard_lag: int = 0
    # Deterministic stats schedule: consume each frame's stats sample at
    # EXACTLY stats_hard_lag frames of age (blocking when the readback is
    # slower than dispatch) instead of opportunistically when it lands.
    # Pins every keyframe / lost / loop decision to a fixed schedule —
    # run-to-run reproducibility at a bounded throughput cost (at worst
    # one blocking readback per frame). Off by default; the
    # mono benches enable it (their accuracy depends on decision timing
    # far more than stereo's).
    stats_deterministic: bool = False

    # Backend
    ba_iters: int = 8
    ba_huber_px: float = 3.0
    ba_trunc_px: float = 10.0
    run_ba: bool = True
    # "reprojection" (geometric, backend/ba.py), "photometric" — the
    # reference's stated intent: 16-dim 4x4-patch intensity residuals
    # (bundle_adjuster.h:58-106; backend/ba_photometric.py) — or "auto":
    # photometric for MonocularVO (the reference is a monocular system
    # and its dead backend is photometric), reprojection for stereo.
    ba_backend: str = "auto"
    photo_ba_level: int = 1      # pyramid level photometric residuals run on
    photo_ba_huber: float = 12.0  # gray levels
    # Distributed window BA (north-star config 5): landmark-sharded
    # LM+Schur over a device mesh (parallel/dist_ba.py) — camera blocks
    # replicated, landmarks + their Schur marginalization shard-local,
    # only the (6C)^2 reduced system psum'd across devices. Requires the
    # reprojection backend. mesh_devices=0 uses every visible device.
    distribute_ba: bool = False
    mesh_devices: int = 0

    # Stereo
    max_disparity: int = 128
    min_stereo_depth: float = 0.5
    max_stereo_depth: float = 80.0

    seed: int = 0

    def intrinsics(self):
        return cam_mod.Intrinsics.create(self.fx, self.fy, self.cx, self.cy)


@dataclass
class FrameResult:
    R: np.ndarray
    t: np.ndarray
    num_tracked: int = 0
    num_landmarks: int = 0
    is_keyframe: bool = False
    state: str = "init"


class BaseVO:
    """Shared machinery for monocular and stereo engines."""

    def __init__(self, config: VOConfig):
        self.cfg = config
        self.intr = config.intrinsics()
        self.key = jax.random.PRNGKey(config.seed)
        self.map = map_state.empty(
            config.max_keyframes,
            config.max_landmarks,
            (config.height, config.width),
            config.pyramid_levels,
        )
        self.frame_idx = -1
        self.last_pyr = None
        self.R = jnp.eye(3, dtype=jnp.float32)
        self.t = jnp.zeros(3, jnp.float32)
        self.prev_R = self.R
        self.prev_t = self.t
        # Filtered per-frame velocity twist (EMA over healthy frames):
        # the track kernel's constant-velocity warm start and the
        # degraded-regime hold both read THIS, not the raw single-step
        # twist (see _build_track_kernel).
        self.vel_xi = jnp.zeros(6, jnp.float32)
        self.last_kf_frame = -(10**9)
        self.kf_order: list[int] = []   # slots, oldest first
        self.results: list[FrameResult] = []
        self._kernels: dict = {}
        # Debug overlays (run.py --viz-every): when True, each tracked
        # frame stashes (ok_mask, refined_uv, image) as DEVICE arrays in
        # self._last_track — pulling them is the caller's choice (and
        # cost: one D2H per overlay, so it is off by default).
        self.debug_overlay = False
        self._last_track = None

    # -- helpers -------------------------------------------------------
    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def _next_kf_slot(self) -> int:
        cfg = self.cfg
        if len(self.kf_order) < cfg.max_keyframes:
            used = set(self.kf_order)
            for s in range(cfg.max_keyframes):
                if s not in used:
                    return s
        # Evict the oldest.
        oldest = self.kf_order.pop(0)
        self.map = map_state.evict_keyframe(self.map, oldest)
        return oldest

    def _post_keyframe(self, slot: int, pyr) -> None:
        """Hook invoked after a keyframe is fully integrated (inserted,
        window-BA-refined, templates rebuilt). SLAM layers add pose-
        graph nodes / loop detection here. Default: no-op."""

    def _recent_motion(self):
        """(speed m/frame, rot rad/frame) medians over the last HEALTHY
        frames (num_tracked above the tracking floor). Frames of a
        collapse hold or drag the pose, so a plain recent-window median
        reads ~zero exactly when callers need the estimate (recovery
        scale priors, dead-reckoning seam budgets). A few small D2H
        pulls per call — call at recovery/re-init time, not per frame.
        Returns (None, None) with too little history."""
        healthy = [
            (i, r)
            for i, r in enumerate(self.results)
            if r.num_tracked >= self.cfg.min_tracked_points
        ]
        take = healthy[-12:]
        if len(take) < 5:
            return None, None
        idxs = np.array([i for i, _ in take])
        # ONE stacked pull instead of one device->host sync per result.
        R = np.asarray(jnp.stack([r.R for _, r in take]))
        t = np.asarray(jnp.stack([r.t for _, r in take]))
        c = -np.einsum("nji,nj->ni", R, t)
        gaps = np.diff(idxs)
        steps = np.linalg.norm(np.diff(c, axis=0), axis=-1) / gaps
        tr = np.einsum("nii->n", np.einsum("nij,nkj->nik", R[1:], R[:-1]))
        angs = np.arccos(np.clip((tr - 1) / 2, -1, 1)) / gaps
        sp = float(np.median(steps))
        rr = float(np.median(angs))
        return (sp if sp > 1e-6 else None), (rr if rr > 1e-9 else None)

    def _seam_span(self, recovery_frame: int) -> int:
        """Frames of dead reckoning ending at `recovery_frame`: distance
        back to the last healthy frame."""
        upto = min(recovery_frame, len(self.results))
        for i in range(upto - 1, -1, -1):
            if self.results[i].num_tracked >= self.cfg.min_tracked_points:
                return max(1, recovery_frame - i)
        return max(1, recovery_frame)

    def _next_kf_slot_peek(self) -> int:
        """Pick the slot for the next keyframe; pops the oldest from
        kf_order if the window is full (eviction itself happens inside
        the insertion kernel)."""
        cfg = self.cfg
        if len(self.kf_order) < cfg.max_keyframes:
            used = set(self.kf_order)
            for s in range(cfg.max_keyframes):
                if s not in used:
                    return s
        return self.kf_order.pop(0)

    def _detect(self, pyr):
        cfg = self.cfg
        per_cell = max(
            1, cfg.num_features // (cfg.detect_grid[0] * cfg.detect_grid[1])
        )
        if cfg.detect_levels > 1:
            return fast.detect_grid_pyramid(
                pyr, threshold=cfg.fast_threshold, grid=cfg.detect_grid,
                per_cell=per_cell, levels=cfg.detect_levels,
            )
        return fast.detect_grid(
            pyr[0], threshold=cfg.fast_threshold, grid=cfg.detect_grid,
            per_cell=per_cell,
        )

    # -- jitted per-frame super-kernels ---------------------------------
    # The whole tracking step (direct + alignment + pose refinement) and
    # the whole keyframe insertion are each ONE jit call: eager per-op
    # dispatch would dominate frame time, so the per-frame host<->device
    # surface is kept to one launch + a few scalar readbacks.

    def _build_track_kernel(self):
        cfg = self.cfg
        intr = self.intr

        @jax.jit
        def track(
            m: map_state.MapState, templates, active, img, R, t, vel_xi,
        ):
            # Pyramid built in-kernel: one host->device launch per frame.
            # Images arrive as uint8 (4x less host-to-device traffic)
            # and are promoted to f32 on device.
            pyr = pyramid.build_pyramid(img.astype(jnp.float32), cfg.pyramid_levels)

            def clamp_twist(xi):
                t_norm = jnp.linalg.norm(xi[:3])
                r_norm = jnp.linalg.norm(xi[3:])
                rho = xi[:3] * jnp.minimum(
                    1.0,
                    cfg.max_step_translation / jnp.maximum(t_norm, 1e-9),
                )
                phi = xi[3:] * jnp.minimum(
                    1.0, cfg.max_step_rotation / jnp.maximum(r_norm, 1e-9)
                )
                return jnp.concatenate([rho, phi])

            # Constant-velocity warm start from the FILTERED velocity
            # twist (EMA over healthy frames, clamped). The r1-r4 warm
            # start used the raw single-step twist; its per-step
            # rotation noise (~0.1-0.3 deg) is harmless for one frame
            # but COMPOUNDS verbatim whenever the degraded regime holds
            # the motion model through an occlusion pass (measured on
            # the mono corridor: 12 deg of yaw error acquired in one
            # ~40-frame crisis window, flat everywhere else).
            xi_warm = clamp_twist(vel_xi)
            dR, dt = se3.se3_exp(xi_warm)
            R0, t0 = se3.compose(dR, dt, R, t)

            # Active subset: frozen per keyframe (chosen when templates
            # were built), so the heavy per-point kernels run on A slots
            # instead of L and the frozen templates stay aligned.
            L = m.points.shape[0]
            pts_a = m.points[active]
            mask_a = m.point_mask[active]

            # Direct tracking against the newest keyframe's frozen
            # templates: half the window DMAs of frame-to-frame tracking
            # and no per-frame template sampling / Jacobian build.
            R_d, t_d, cost = direct.estimate_pose_templated(
                templates, pyr, pts_a, intr, R0, t0,
                direct.DirectParams(iters=cfg.direct_iters),
            )
            p_cam = se3.transform(R_d, t_d, pts_a)
            uv_pred, depth = cam_mod.project(p_cam, intr)
            visible = (
                mask_a
                & (depth > 0.1)
                & cam_mod.is_inside(uv_pred, cfg.height, cfg.width, border=8)
            )
            k_idx_a, cos = align.select_reference_keyframes(
                pts_a, m.kf_R, m.kf_t, m.kf_mask, m.obs_mask[:, active]
            )
            has_obs = m.obs_mask[k_idx_a, active]
            uv_ref = m.obs_uv[k_idx_a, active]
            refined_a, err, ok_a = align.align(
                m.kf_pyr, k_idx_a, uv_ref, pyr, uv_pred, visible & has_obs,
                align.AlignParams(iters=cfg.align_iters),
            )
            x_ref = cam_mod.normalize(refined_a, intr)
            # 4 LM iterations: the warm start is the converged direct
            # pose, so the reprojection refinement is near-linear; each
            # iteration costs a fixed ~0.3 ms of op-dispatch latency.
            R_f, t_f = pnp.refine_pose(
                R_d, t_d, pts_a, x_ref,
                ok_a.astype(jnp.float32),
                huber=cfg.ransac_threshold_px / cfg.fx,
                iters=4,
            )
            n_tracked = jnp.sum(ok_a)
            # Acceleration sanity of the refined candidate: its step
            # must stay within max_accel_* of the filtered velocity
            # (see VOConfig) — a wildly-deviating step is a degenerate
            # solve (occluded/clustered landmark geometry), and in
            # monocular tracking one such step permanently re-anchors
            # the segment (poses carry the scale AND the heading).
            dRm, dtm = se3.relative(R_f, t_f, R, t)
            xi_meas = clamp_twist(se3.se3_log(dRm, dtm))
            dev = xi_meas - vel_xi
            sane = (
                (jnp.linalg.norm(dev[3:]) <= cfg.max_accel_rotation)
                & (jnp.linalg.norm(dev[:3]) <= cfg.max_accel_translation)
            )
            use_refined = (n_tracked >= cfg.min_tracked_points) & sane
            # Lost frame: HOLD the previous pose instead of dead-reckoning.
            # Keyframe-templated tracking (unlike frame-to-frame) never
            # re-measures relative motion once the template is invisible,
            # so a bogus constant-velocity estimate would otherwise
            # self-perpetuate at the clamp limit forever (observed: a
            # 3-frame sensor blackout turned into permanent 3 m/frame
            # drift that outran every later recovery keyframe's warm
            # start). Zero velocity keeps the recovery keyframe's
            # landmarks inside the next frame's GN convergence basin.
            lost = n_tracked < cfg.min_lost_points
            # Degraded regime (min_lost <= tracked < min_tracked): hold
            # the clamped constant-velocity model (R0, t0) instead of a
            # starved solve. A pose fit against <30 (mostly-occluded)
            # landmarks is noise, and in MONOCULAR tracking its damage
            # is permanent: poses carry the segment scale, so garbage
            # steps during an occlusion pass re-anchor all subsequent
            # triangulation at a new scale (measured: a near-field
            # obstacle pass at 10 tracked landmarks blew the segment
            # scale up 10x with no re-init to mark it). The motion
            # model is scale-consistent by construction; the gates
            # filter what its pose errors do to new landmarks.
            R_new = jnp.where(use_refined, R_f, jnp.where(lost, R, R0))
            t_new = jnp.where(use_refined, t_f, jnp.where(lost, t, t0))
            # Velocity filter update: blend in THIS frame's measured
            # step only when the solve was trusted; held/lost frames
            # keep the filter (their "step" is the filter's own
            # prediction — or zero — and would only wash it out).
            vel_new = jnp.where(
                use_refined, 0.7 * vel_xi + 0.3 * xi_meas, vel_xi
            )
            # Scatter results back to full landmark index space.
            ok_align = jnp.zeros(L, bool).at[active].set(ok_a)
            refined = jnp.zeros((L, 2), refined_a.dtype).at[active].set(refined_a)
            # Pack the per-frame scalars into ONE small array so the host
            # needs a single device->host transfer. An accel-gate
            # rejection reports a LOST frame: physically-absurd solves
            # are evidence tracking is broken, and the host's lost
            # counter should see it.
            n_rep = jnp.where(sane, n_tracked, 0)
            stats = jnp.stack(
                [n_rep.astype(jnp.int32), m.num_points.astype(jnp.int32)]
            )
            return R_new, t_new, ok_align, refined, stats, pyr, vel_new

        return track

    def _build_template_kernel(self):
        cfg = self.cfg
        intr = self.intr
        A = min(cfg.track_landmarks, cfg.max_landmarks)

        @jax.jit
        def build(m: map_state.MapState, slot):
            # Active subset for the inter-keyframe tracking epoch: valid
            # landmarks first, those observed in the new keyframe ahead
            # of the rest. Frozen until the next keyframe so the
            # templates and the track kernel index the same slots.
            priority = (
                m.point_mask.astype(jnp.int32) * 2
                + (m.point_mask & m.obs_mask[slot]).astype(jnp.int32)
            )
            active = jnp.argsort(-priority)[:A]
            pts_a = m.points[active]
            mask_a = m.point_mask[active]
            pyr_kf = tuple(lvl[slot] for lvl in m.kf_pyr)
            templates = direct.build_templates(
                pyr_kf, m.kf_R[slot], m.kf_t[slot], pts_a, mask_a, intr
            )
            return templates, active

        return build

    def _refresh_templates(self, slot: int):
        """(Re)build the frozen tracking templates from keyframe `slot`.

        Called after every keyframe insertion (post-BA, so templates see
        the adjusted pose and landmarks). One extra async kernel launch
        per keyframe buys per-frame tracking half its window DMAs."""
        if "templates" not in self._kernels:
            self._kernels["templates"] = self._build_template_kernel()
        self._templates, self._active_idx = self._kernels["templates"](
            self.map, slot
        )

    # Per-engine default when cfg.ba_backend == "auto" (MonocularVO
    # overrides to "photometric" — the reference's stated backend intent).
    _default_ba_backend = "reprojection"

    def _ba_backend(self) -> str:
        b = self.cfg.ba_backend
        if b == "auto":
            b = self._default_ba_backend
        if self.cfg.distribute_ba:
            if b == "photometric" and self.cfg.ba_backend != "auto":
                raise ValueError(
                    "distribute_ba supports only the reprojection backend"
                )
            b = "reprojection"
        return b

    def _build_dist_ba_kernel(self):
        """Window BA over a device mesh (north-star config 5).

        Three cached executables per engine: a single-device prep
        (problem build + landmark padding), the shared landmark-sharded
        LM+Schur solver (parallel/dist_ba.make_sharded_solver — cached,
        NOT re-wrapped per call), and a single-device finish (write-back
        + newest-pose extraction). Explicit device_put moves the problem
        onto the mesh and the solution back to device 0 so every other
        engine kernel stays single-device.
        """
        import jax.sharding as jshard

        from viso_tpu.parallel import dist_ba, mesh as mesh_mod

        cfg = self.cfg
        intr = self.intr
        mesh = mesh_mod.make_mesh(cfg.mesh_devices or None)
        n_dev = mesh.devices.size
        params = ba.BAParams(
            iters=cfg.ba_iters,
            huber=cfg.ba_huber_px / cfg.fx,
            trunc=cfg.ba_trunc_px / cfg.fx,
            num_fixed=0,
        )
        solver = dist_ba.make_sharded_solver(mesh, params)
        L0 = cfg.max_landmarks

        @jax.jit
        def prep(m: map_state.MapState, cam_fixed):
            prob = map_state.as_ba_problem(m, intr)
            prob = prob._replace(cam_fixed=cam_fixed)
            return dist_ba.pad_landmarks(prob, n_dev)

        @jax.jit
        def finish(m: map_state.MapState, R, t, points, pose_slot, R0, t0):
            m_new = map_state.update_from_ba(m, R, t, points[:L0])
            return BaseVO._gate_ba_adoption(
                m, m_new, m_new.kf_R[pose_slot], m_new.kf_t[pose_slot],
                R0, t0, cfg,
            )

        P = jshard.PartitionSpec
        shard_l = jshard.NamedSharding(mesh, P(mesh_mod.LANDMARK_AXIS))
        shard_cl = jshard.NamedSharding(mesh, P(None, mesh_mod.LANDMARK_AXIS))
        repl = jshard.NamedSharding(mesh, P())
        in_shardings = ba.BAProblem(
            R=repl, t=repl, points=shard_l, obs_uv=shard_cl,
            obs_mask=shard_cl, cam_mask=repl, point_mask=shard_l,
            cam_fixed=repl,
        )
        # The engine's single-device kernels live on THIS process's
        # first device: in a multi-process cluster jax.devices()[0] may
        # belong to another process (non-addressable).
        dev0 = jax.local_devices()[0]
        multiproc = jax.process_count() > 1
        if multiproc:
            # Cross-process: the solver's outputs span non-addressable
            # devices. Force them REPLICATED (XLA inserts the
            # all-gather, collectively on every process), then read the
            # local full copy and stage it back to the local device.
            import functools as _ft

            @_ft.partial(jax.jit, out_shardings=repl)
            def collect(R, t, points, cost):
                return R, t, points, cost

        def run(m, cam_fixed, pose_slot, R0, t0):
            prob = prep(m, cam_fixed)
            if multiproc:
                # Host-stage the (identical-on-every-process) problem so
                # device_put can scatter it onto the global mesh.
                prob = jax.tree.map(np.asarray, prob)
            prob = jax.device_put(prob, in_shardings)
            out, info = solver(prob)
            if multiproc:
                R, t, points, cost = collect(
                    out.R, out.t, out.points, info["final_cost"]
                )
                R, t, points = (
                    jax.device_put(np.asarray(x), dev0)
                    for x in (R, t, points)
                )
                cost = np.asarray(cost)
            else:
                R, t, points, cost = jax.device_put(
                    (out.R, out.t, out.points, info["final_cost"]), dev0
                )
            m, R_new, t_new = finish(m, R, t, points, pose_slot, R0, t0)
            return m, cost, R_new, t_new

        return run

    @staticmethod
    def _gate_ba_adoption(m_old, m_new, R_new, t_new, R0, t0, cfg):
        """Accept the BA result only when its newest-pose shift is
        physically sane (same acceleration bounds as the track kernel's
        solve gate): a window poisoned by an occlusion crisis can
        'converge' to a pose 10+ degrees away in one keyframe, and that
        jump bypasses every per-frame gate (measured: the mono
        corridor's entire 13-degree rotation error arrived through ONE
        such BA adoption). Rejection keeps the pre-BA map and pose."""
        dR, dt = se3.relative(R_new, t_new, R0, t0)
        xi = se3.se3_log(dR, dt)
        sane = (
            (jnp.linalg.norm(xi[3:]) <= cfg.max_ba_shift_rotation)
            & (jnp.linalg.norm(xi[:3]) <= cfg.max_ba_shift_translation)
        )
        m = jax.tree.map(
            lambda a, b: jnp.where(sane, a, b), m_new, m_old
        )
        R_out = jnp.where(sane, R_new, R0)
        t_out = jnp.where(sane, t_new, t0)
        return m, R_out, t_out

    def _run_window_ba(self, fixed_slots):
        cfg = self.cfg
        cam_fixed = np.zeros(cfg.max_keyframes, bool)
        for s in fixed_slots:
            cam_fixed[s] = True
        if "ba" not in self._kernels:
            intr = self.intr
            # Resolve (and VALIDATE) the backend before branching on
            # distribute_ba: an explicit photometric request combined
            # with distribute_ba must raise here, not silently run the
            # reprojection solver (ADVICE r2).
            backend = self._ba_backend()
            if cfg.distribute_ba:
                run_ba = self._build_dist_ba_kernel()
            elif backend == "photometric":
                from viso_tpu.backend import ba_photometric as pba

                pparams = pba.PhotoBAParams(
                    iters=cfg.ba_iters,
                    huber=cfg.photo_ba_huber,
                    num_fixed=0,
                )
                level = cfg.photo_ba_level

                @jax.jit
                def run_ba(m: map_state.MapState, cam_fixed, pose_slot,
                           R0, t0):
                    prob, intr_l = map_state.as_photo_ba_problem(
                        m, intr, level=level
                    )
                    prob = prob._replace(cam_fixed=cam_fixed)
                    out, info = pba.solve_impl(prob, intr_l, pparams)
                    m_new = map_state.update_from_ba(
                        m, out.R, out.t, out.points
                    )
                    # Newest keyframe's adjusted pose, returned directly:
                    # a host-side m.kf_R[slot] would cost two extra
                    # dispatches per keyframe.
                    m_out, R_out, t_out = BaseVO._gate_ba_adoption(
                        m, m_new, out.R[pose_slot], out.t[pose_slot],
                        R0, t0, cfg,
                    )
                    return m_out, info["final_cost"], R_out, t_out
            else:
                params = ba.BAParams(
                    iters=cfg.ba_iters,
                    huber=cfg.ba_huber_px / cfg.fx,
                    trunc=cfg.ba_trunc_px / cfg.fx,
                    num_fixed=0,
                )

                @jax.jit
                def run_ba(m: map_state.MapState, cam_fixed, pose_slot,
                           R0, t0):
                    prob = map_state.as_ba_problem(m, intr)
                    prob = prob._replace(cam_fixed=cam_fixed)
                    out, info = ba.solve_impl(prob, params)
                    m_new = map_state.update_from_ba(
                        m, out.R, out.t, out.points
                    )
                    m_out, R_out, t_out = BaseVO._gate_ba_adoption(
                        m, m_new, out.R[pose_slot], out.t[pose_slot],
                        R0, t0, cfg,
                    )
                    return m_out, info["final_cost"], R_out, t_out

            self._kernels["ba"] = run_ba
        slot = self.kf_order[-1]
        R0, t0 = self.R, self.t
        self.map, final_cost, self.R, self.t = self._kernels["ba"](
            self.map, jnp.asarray(cam_fixed), slot, R0, t0
        )
        # Transfer BA's pose correction onto prev_* (world-side:
        # T_new = T_old o G^-1  =>  prev_new = prev_old o (T0^-1 o T1)),
        # which keeps rel(T, prev) — the constant-velocity estimate —
        # EXACTLY unchanged. Leaving prev untouched makes the motion
        # model read the correction as velocity and extrapolate it next
        # frame; stacked on a loop-closure world remap this measurably
        # threw the warm start out of the tracker's convergence basin.
        Gi = se3.compose(*se3.inverse(R0, t0), self.R, self.t)
        self.prev_R, self.prev_t = se3.compose(
            self.prev_R, self.prev_t, *Gi
        )
        return final_cost

    def _track_landmarks(self, img):
        """One jitted call: pyramid + direct tracking + alignment + refine.

        Returns (ok_align (L,), refined_uv (L, 2), n_tracked int, pyr).

        The returned n_tracked is a frame or two STALE: a background
        thread fetches each frame's stats (np.asarray blocks *that*
        thread on compute + D2H copy); the frame loop polls completed
        fetches and consumes the newest, force-joining only when more
        than `stats_max_lag` are in flight. A same-frame readback would
        serialize the host with device compute every frame.
        """
        if "track" not in self._kernels:
            self._kernels["track"] = self._build_track_kernel()
        (
            R_new, t_new, ok_align, refined, stats, pyr, vel_new
        ) = self._kernels["track"](
            self.map, self._templates, self._active_idx, img,
            self.R, self.t, self.vel_xi,
        )
        self.prev_R, self.prev_t = self.R, self.t
        self.R, self.t = R_new, t_new
        self.vel_xi = vel_new
        q = getattr(self, "_pending_stats_q", None)
        if q is None:
            q = self._pending_stats_q = []
            import concurrent.futures

            # One worker per allowed in-flight fetch so every queued
            # fetch is always making progress (a starved fetch would
            # never report done()).
            self._stats_reader = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(2, self.cfg.stats_max_lag),
                thread_name_prefix="viso-stats",
            )
        # Submit a fetch only when the pipeline has room: the stats
        # SAMPLING RATE self-adjusts to the D2H throughput, instead of
        # force-joining the oldest fetch whenever the queue is full
        # (which serializes every readback with dispatch).
        if len(q) < max(1, self.cfg.stats_max_lag):
            try:
                # Start the D2H copy NOW so the worker's np.asarray
                # finds the bytes already in flight.
                stats.copy_to_host_async()
            except AttributeError:
                pass
            q.append(
                (self.frame_idx, self._stats_reader.submit(np.asarray, stats))
            )
        # Consume every fetch that has landed host-side (non-blocking) —
        # or, in DETERMINISTIC mode, consume each fetch at EXACTLY
        # stats_hard_lag frames of age (blocking if it has not landed).
        # Opportunistic consumption makes keyframe / lost / loop
        # decisions depend on readback-timing races: identical inputs
        # produced 4-13 loops and 0.45-1.7 m ATE across mono-orbit runs.
        # Fixed-age consumption pins the whole decision schedule; at
        # steady state the fetch has landed by age Δ (Δ ≈ readback
        # latency / frame time), so the join is free unless dispatch
        # outruns the readback.
        consumed = None
        if self.cfg.stats_deterministic:
            delta = self.cfg.stats_hard_lag or self.cfg.stats_max_lag
            while q and self.frame_idx - q[0][0] >= delta:
                f, fut = q.pop(0)
                consumed = (f, fut.result())
        else:
            while q and q[0][1].done():
                f, fut = q.pop(0)
                consumed = (f, fut.result())
        # Hard staleness bound: a fetch completes only when ITS frame's
        # device compute has finished, so on a backend where dispatch
        # outruns compute (CPU tests dispatch in ~1 ms while a frame
        # computes for ~50-100 ms) a purely non-blocking loop races
        # unboundedly ahead and no sample ever lands — keyframe / lost
        # decisions then degrade to the blind gap schedule, and the
        # in-flight work queue grows without bound. Force-joining the
        # oldest fetch once it is `hard` FRAMES old (age-based, unlike
        # round 1's queue-occupancy join) applies backpressure exactly
        # when dispatch outruns compute, bounding both staleness and
        # pipeline depth. The parameter exists to absorb D2H landing
        # latency; on a host-attached device (CPU or PCIe) fetches land
        # within a frame, so a tight default keeps keyframe/lost
        # decisions fresh at zero cost.
        hard = self.cfg.stats_hard_lag or max(2, self.cfg.stats_max_lag)
        if q and self.frame_idx - q[0][0] >= hard:
            f, fut = q.pop(0)
            consumed = (f, fut.result())
            while q and q[0][1].done():   # drain anything newer that landed
                f, fut = q.pop(0)
                consumed = (f, fut.result())
        if consumed is not None:
            self._stats_frame = consumed[0]
            n_tracked, n_points = (int(v) for v in consumed[1])
            self._n_points_cache = n_points
            self._n_tracked_cache = n_tracked
        # Pipeline still filling (no sample ever landed): be optimistic —
        # no KF / lost decisions should fire off the first missing samples.
        n_tracked = getattr(self, "_n_tracked_cache", self.cfg.num_features)
        if self.debug_overlay:
            # Stamped with the frame index so overlay writers can skip
            # stale data from before a re-init / init frame (ADVICE r2).
            self._last_track = (ok_align, refined, pyr[0], self.frame_idx)
        return ok_align, refined, n_tracked, pyr

    def close(self):
        """Release the background stats reader (threads are otherwise
        only reclaimed at interpreter exit)."""
        ex = getattr(self, "_stats_reader", None)
        if ex is not None:
            self._stats_reader = None
            ex.shutdown(wait=False, cancel_futures=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _stats_fresh(self) -> bool:
        """True when the last consumed stats sample postdates the newest
        keyframe — i.e. it reflects the post-insert map. Pre-insert
        samples must not drive keyframe / lost-tracking decisions."""
        return getattr(self, "_stats_frame", -1) > self.last_kf_frame

    def _update_lost(self, n_tracked) -> bool:
        """Advance the lost-tracking counter; True = force recovery now.

        Only FRESH stats samples move the counter (a stale sample is
        pre-insert evidence: it neither confirms loss nor recovery, so
        the counter holds — resetting on staleness would starve recovery
        behind a deep stats pipeline, where every keyframe insert makes
        several following frames stale). Generalizes the reference's
        blanket re-seed every `reinitialize_after` frames
        (viso.h:20, viso.cpp:14,100-108) into evidence-driven recovery.
        """
        cfg = self.cfg
        if self._stats_fresh():
            if n_tracked < cfg.min_lost_points:
                self._lost_count = getattr(self, "_lost_count", 0) + 1
            else:
                self._lost_count = 0
        forced = getattr(self, "_lost_count", 0) >= cfg.lost_reinit_after
        if forced:
            self._lost_count = 0
        return forced

    def _should_insert_keyframe(self, n_tracked):
        cfg = self.cfg
        gap = self.frame_idx - self.last_kf_frame
        if gap < cfg.kf_min_gap:
            return False
        if gap >= cfg.kf_max_gap:
            return True
        if not self._stats_fresh():
            return False
        n_landmarks = getattr(self, "_n_points_cache", None)
        if n_landmarks is None:
            n_landmarks = int(self.map.num_points)
        if n_landmarks == 0:
            return True
        return n_tracked < cfg.kf_min_visible_frac * min(
            n_landmarks, self.cfg.num_features
        )

    def trajectory(self):
        """Per-frame world->cam poses as (N, 3, 3) / (N, 3) arrays.

        Results hold device arrays (no per-frame sync). Pulled here as
        ONE stacked device op + one D2H transfer instead of one sync
        per frame.
        """
        return _pull_poses(self.results)

    def _record(self, **kw):
        self.results.append(FrameResult(R=self.R, t=self.t, **kw))


class StereoVO(BaseVO):
    """Stereo visual odometry: disparity triangulation + PnP tracking +
    sliding-window BA (BASELINE.json config 2/3)."""

    def __init__(self, config: VOConfig):
        super().__init__(config)
        self.state = "init"

    @staticmethod
    def to_device(img_left, img_right):
        """Pre-upload a stereo pair (uint8) — call one frame ahead to
        overlap the host->device transfer with the previous frame's
        compute. process() accepts the returned pair directly."""
        def conv(im):
            if isinstance(im, jnp.ndarray):
                return im
            a = np.asarray(im)
            if a.dtype != np.uint8:
                a = np.clip(a, 0, 255).astype(np.uint8)
            return jnp.asarray(a)

        return conv(img_left), conv(img_right)

    def process(self, img_left, img_right) -> FrameResult:
        cfg = self.cfg
        self.frame_idx += 1
        img_left, img_right = self.to_device(img_left, img_right)

        if self.state == "init":
            pyr = pyramid.build_pyramid(
                img_left.astype(jnp.float32), cfg.pyramid_levels
            )
            slot = self._insert_stereo_keyframe(pyr, img_left, img_right)
            self._refresh_templates(slot)
            self._post_keyframe(slot, pyr)
            self.state = "tracking"
            self.last_pyr = pyr
            self.last_kf_frame = self.frame_idx
            self._n_points_cache = int(self.map.num_points)
            self._record(
                num_tracked=0,
                num_landmarks=self._n_points_cache,
                is_keyframe=True,
                state="init",
            )
            return self.results[-1]

        ok_align, refined, n_tracked, pyr = self._track_landmarks(img_left)

        # Lost-tracking recovery: after a few nearly-trackless frames,
        # force a fresh stereo keyframe (new landmarks re-anchor the
        # tracker at the predicted pose). Only post-insert stats count —
        # a stale pre-keyframe sample would re-trigger recovery forever.
        forced_recovery = self._update_lost(n_tracked)
        if forced_recovery:
            # Consumers (e.g. SLAM loop gating) need to know this
            # keyframe re-anchors after dead reckoning: its pose and the
            # odometry edge into it are low-confidence.
            self._last_recovery_frame = self.frame_idx
        is_kf = forced_recovery or self._should_insert_keyframe(n_tracked)
        if is_kf:
            # Record refined observations of tracked landmarks, then add
            # fresh stereo landmarks and run window BA.
            slot = self._insert_stereo_keyframe(
                pyr, img_left, img_right, existing_obs=(ok_align, refined)
            )
            self.last_kf_frame = self.frame_idx
            if cfg.run_ba and len(self.kf_order) >= 2:
                fixed = self.kf_order[:1]
                # Tracking pose follows the (possibly shifted) newest KF;
                # _run_window_ba returns it from the BA kernel directly.
                self._run_window_ba(fixed)
            # Templates rebuilt post-BA so they bake the adjusted pose
            # and landmarks. num_points refreshes from the next frame's
            # stats readback — no blocking sync here.
            self._refresh_templates(slot)
            # Post-BA keyframe hook (SLAM layers add pose-graph nodes /
            # loop detection here, seeing the refined pose and map).
            self._post_keyframe(slot, pyr)

        self.last_pyr = pyr
        self._record(
            num_tracked=n_tracked,
            num_landmarks=getattr(self, "_n_points_cache", 0),
            is_keyframe=is_kf,
            state=self.state,
        )
        return self.results[-1]

    def _build_stereo_kf_kernel(self):
        cfg = self.cfg
        intr = self.intr
        sparams = stereo.StereoParams(max_disparity=cfg.max_disparity)
        per_cell = max(
            1, cfg.num_features // (cfg.detect_grid[0] * cfg.detect_grid[1])
        )

        @jax.jit
        def insert(
            m: map_state.MapState,
            slot,
            do_evict,
            R,
            t,
            frame_id,
            pyr,
            img_left,
            img_right,
            ok_align,
            refined,
            have_existing,
        ):
            # Conditional eviction of the slot being recycled.
            m_ev = map_state.evict_keyframe(m, slot)
            m = jax.tree.map(
                lambda a, b: jnp.where(do_evict, a, b), m_ev, m
            )
            img_left = img_left.astype(jnp.float32)
            img_right = img_right.astype(jnp.float32)
            m = map_state.insert_keyframe(m, slot, R, t, frame_id, pyr)
            existing = ok_align & have_existing
            m = map_state.set_observations(
                m, slot, jnp.arange(m.points.shape[0]), refined, existing
            )
            if cfg.detect_levels > 1:
                uv, score, det_mask = fast.detect_grid_pyramid(
                    pyr, threshold=cfg.fast_threshold, grid=cfg.detect_grid,
                    per_cell=per_cell, levels=cfg.detect_levels,
                )
            else:
                uv, score, det_mask = fast.detect_grid(
                    pyr[0], threshold=cfg.fast_threshold,
                    grid=cfg.detect_grid, per_cell=per_cell,
                )
            det_mask = det_mask & ~_near_existing(uv, refined, existing, 8.0)
            disp, cost, ok_d = stereo.match(
                img_left, img_right, uv, det_mask, sparams
            )
            depth = stereo.disparity_to_depth(disp, cfg.fx, cfg.baseline, ok_d)
            good = (
                ok_d
                & (depth > cfg.min_stereo_depth)
                & (depth < cfg.max_stereo_depth)
            )
            budget = jnp.maximum(0, cfg.num_features - jnp.sum(existing))
            good = _top_m_by_score(good, score, budget)
            p_cam = cam_mod.backproject(uv, depth, intr)
            R_inv, t_inv = se3.inverse(R, t)
            p_world = se3.transform(R_inv, t_inv, p_cam)
            m, slots, ok_alloc = map_state.allocate_landmarks(m, p_world, good)
            m = map_state.set_observations(m, slot, slots, uv, ok_alloc)
            return m

        return insert

    def _insert_stereo_keyframe(
        self, pyr, img_left, img_right, existing_obs=None
    ) -> int:
        cfg = self.cfg
        evict = len(self.kf_order) >= cfg.max_keyframes
        slot = self._next_kf_slot_peek()
        self.kf_order.append(slot)
        if existing_obs is not None:
            ok_align, refined = existing_obs
            have = jnp.asarray(True)
        else:
            ok_align = jnp.zeros(cfg.max_landmarks, bool)
            refined = jnp.zeros((cfg.max_landmarks, 2), jnp.float32)
            have = jnp.asarray(False)
        if "stereo_kf" not in self._kernels:
            self._kernels["stereo_kf"] = self._build_stereo_kf_kernel()
        self.map = self._kernels["stereo_kf"](
            self.map,
            slot,
            jnp.asarray(evict),
            self.R,
            self.t,
            self.frame_idx,
            pyr,
            img_left,
            img_right,
            ok_align,
            refined,
            have,
        )
        return slot



class MonocularVO(BaseVO):
    """Monocular VO: LK bootstrap + two-view init + direct/aligned tracking
    (BASELINE.json config 1; the reference pipeline end-to-end).

    Lost-tracking parity with StereoVO: after `lost_reinit_after`
    consecutive fresh lost samples the engine re-initializes — a new
    two-view bootstrap anchored at the current pose (the reference's
    re-seed loop, viso.cpp:14,100-108, generalized to mid-run recovery).
    Monocular scale is NOT observable across a re-init: the new segment
    is mean-depth normalized (viso.cpp:622-637), so absolute scale may
    jump at the seam; within a segment the two frozen gauge cameras in
    window BA hold it.
    """

    _default_ba_backend = "photometric"

    def __init__(self, config: VOConfig):
        super().__init__(config)
        self.state = "init"
        # (ref_pyr, ref_kps, chained_cur_kps, mask, ref_frame_idx)
        self.init_ref = None
        # World->cam pose of the init segment's reference camera: the
        # first bootstrap anchors at identity; a mid-run re-init anchors
        # the new map segment at the pose where tracking was lost.
        self.init_base = (jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32))
        self.num_reinits = 0

    @staticmethod
    def to_device(img):
        """Pre-upload a frame as uint8 (4x less host-link traffic); the
        kernels promote to f32 on device."""
        if isinstance(img, jnp.ndarray):
            return img
        a = np.asarray(img)
        if a.dtype != np.uint8:
            a = np.clip(a, 0, 255).astype(np.uint8)
        return jnp.asarray(a)

    def process(self, img) -> FrameResult:
        cfg = self.cfg
        self.frame_idx += 1
        img = self.to_device(img)

        if self.state == "init":
            pyr = pyramid.build_pyramid(
                img.astype(jnp.float32), cfg.pyramid_levels
            )
            self._dead_reckon()
            self._try_initialize(pyr)
        else:
            ok_align, refined, n_tracked, pyr = self._track_landmarks(img)
            if self._update_lost(n_tracked):
                self._reinitialize(pyr)
                self._record(
                    num_tracked=n_tracked,
                    num_landmarks=0,
                    is_keyframe=False,
                    state="init",
                )
                self.last_pyr = pyr
                return self.results[-1]
            is_kf = self._should_insert_keyframe(n_tracked)
            if is_kf:
                self._insert_mono_keyframe(pyr, (ok_align, refined))
                self.last_kf_frame = self.frame_idx
                if cfg.run_ba and len(self.kf_order) >= 2:
                    # Updates self.R/self.t to the adjusted newest-KF pose.
                    self._run_window_ba(self.kf_order[:2])
                self._refresh_templates(self.kf_order[-1])
                self._post_keyframe(self.kf_order[-1], pyr)
            self.last_pyr = pyr
            self._record(
                num_tracked=n_tracked,
                num_landmarks=getattr(self, "_n_points_cache", 0),
                is_keyframe=is_kf,
                state=self.state,
            )
            return self.results[-1]

        self.last_pyr = pyr
        self._record(
            num_tracked=0,
            num_landmarks=int(self.map.num_points),
            is_keyframe=self.state == "tracking",
            state="init",
        )
        return self.results[-1]

    def _reinitialize(self, pyr):
        """Drop the map and bootstrap a new segment at the current pose."""
        cfg = self.cfg
        self._last_track = None   # overlay data from the old segment is stale
        # Scale prior for the new segment: monocular scale is
        # unobservable across a re-init (the new map is mean-depth
        # normalized, viso.cpp:622-637), so without a prior every
        # recovery introduces a scale JUMP that dominates full-run ATE.
        # The camera's speed is continuous through a short tracking
        # loss, so the median per-frame translation over the last
        # healthy frames anchors the new segment's scale.
        self._scale_prior = self._recent_speed()
        # Depth-continuity anchor (PRIMARY): the visible scene's depth
        # scale is also continuous through a short loss, and unlike the
        # speed prior it transfers robustly. The speed prior fixes the
        # bootstrap BASELINE, but per-frame tracking speed is governed
        # by landmark DEPTHS — and a low-parallax two-view's
        # baseline-to-depth ratio carries up to ~2x error, so a
        # baseline-anchored segment immediately runs at scale/k
        # (measured: intended 0.20, realized 0.127, k=1.6; see
        # tools/diag_mono_seam.py). Anchoring the new map's median
        # landmark depth to the dying map's median depth is insensitive
        # to that ratio error.
        self._depth_prior = self._map_median_depth()
        # Constant-velocity dead reckoning THROUGH the blackout: a
        # re-init takes tens of frames under low-parallax forward
        # motion (the disparity gate needs baseline to accumulate), and
        # holding the pose bakes a zero-motion plateau into the
        # trajectory — measured on the 500-frame mono bench, one
        # 33-frame blackout (5 m of real motion recorded as none) plus
        # its re-init scale seam dominated the ATE (2.6 m). Extrapolate
        # the recorded pose by the pre-loss per-frame increment instead;
        # the two-view measurement overrides it from the ref frame on.
        self._dr_fwd = self._recent_fwd()
        self.map = map_state.empty(
            cfg.max_keyframes,
            cfg.max_landmarks,
            (cfg.height, cfg.width),
            cfg.pyramid_levels,
        )
        self.kf_order = []
        self.state = "init"
        self.init_base = (self.R, self.t)
        self.prev_R, self.prev_t = self.R, self.t   # zero velocity
        # Velocity filter: carry the pre-loss per-frame increment when
        # one exists (it also drives _dead_reckon), else reset.
        dr = getattr(self, "_dr_fwd", None) or self._recent_fwd()
        if dr is not None:
            self.vel_xi = se3.se3_log(
                jnp.asarray(dr[0]), jnp.asarray(dr[1])
            )
        else:
            self.vel_xi = jnp.zeros(6, jnp.float32)
        self.init_ref = None
        self.num_reinits += 1
        # SLAM layers treat the post-reinit odometry edge as dead
        # reckoning (same contract as StereoVO's forced recovery).
        self._last_recovery_frame = self.frame_idx
        # Seed immediately from the current frame.
        self._try_initialize(pyr)

    def _recent_speed(self):
        """Median per-frame camera-center speed (m/frame) over the last
        healthy frames (see BaseVO._recent_motion)."""
        return self._recent_motion()[0]

    def _map_median_depth(self):
        """Median camera-frame depth of the current map's valid
        landmarks (None if the map is empty/degenerate). One small
        device op + D2H; called at re-init time only."""
        m = self.map
        p_cam = se3.transform(self.R, self.t, m.points)
        z = jnp.where(m.point_mask, p_cam[:, 2], jnp.nan)
        med = float(jnp.nanmedian(z))
        if not np.isfinite(med) or med <= 1e-6:
            return None
        return med

    def _recent_fwd(self):
        """Pre-loss per-frame forward increment T_fwd = T_k o T_{k-1}^-1
        (world->cam convention) from the recorded healthy poses, for
        dead reckoning through a tracking blackout. Componentwise-median
        translation over the last adjacent healthy pairs (single-pair
        increments carry per-frame GN jitter), rotation from the newest
        pair. None if too little history or the increment fails the
        motion-model sanity clamps. One stacked D2H pull, re-init only."""
        healthy = [
            (i, r)
            for i, r in enumerate(self.results)
            if r.num_tracked >= self.cfg.min_tracked_points
        ]
        # Slice once, then pair consecutively: zipping two different
        # slices pairs elements with themselves whenever
        # len(healthy) < 9, which silently disabled dead reckoning for
        # short healthy histories (ADVICE r4).
        h = healthy[-9:]
        pairs = [
            (a[1], b[1]) for a, b in zip(h, h[1:]) if b[0] - a[0] == 1
        ]
        if not pairs:
            return None
        R = np.asarray(jnp.stack([r.R for p in pairs for r in p]))
        t = np.asarray(jnp.stack([r.t for p in pairs for r in p]))
        Ra, ta = R[0::2], t[0::2]
        Rb, tb = R[1::2], t[1::2]
        R_f = np.einsum("nij,nkj->nik", Rb, Ra)        # Rb @ Ra^T
        t_f = tb - np.einsum("nij,nj->ni", R_f, ta)
        t_med = np.median(t_f, axis=0).astype(np.float32)
        R_last = R_f[-1].astype(np.float32)
        if not (np.all(np.isfinite(t_med)) and np.all(np.isfinite(R_last))):
            return None
        ang = np.arccos(np.clip((np.trace(R_last) - 1) / 2, -1, 1))
        if (
            np.linalg.norm(t_med) > self.cfg.max_step_translation
            or ang > self.cfg.max_step_rotation
        ):
            return None
        return R_last, t_med

    def _dead_reckon(self):
        """Advance the pose by the pre-loss velocity during a post-
        re-init blackout (no-op otherwise). Two tiny device ops per
        lost frame; no readback."""
        dr = getattr(self, "_dr_fwd", None)
        if dr is None or self.num_reinits == 0:
            return
        R_f, t_f = dr
        self.R = jnp.asarray(R_f) @ self.R
        self.t = jnp.asarray(R_f) @ self.t + jnp.asarray(t_f)

    # -- initialization (reference viso.cpp:13-111) --------------------
    def _try_initialize(self, pyr):
        """Two-view bootstrap with CHAINED correspondence tracking.

        Init features are tracked frame-to-frame from the reference
        (small per-step flow — well inside LK's convergence basin even
        under fast rotation) while the ref<->current correspondence set
        spans the full accumulated baseline. Direct ref->current LK
        (the r1-r4 design, mirroring viso.cpp:36-44) fails exactly when
        a large baseline has accumulated, so it could only ever accept
        tiny-parallax bootstraps whose depth noise destabilized the
        young segment. A dead chain (blackout, occlusion) reseeds
        immediately instead of waiting out reinitialize_after.
        """
        cfg = self.cfg
        ir = self.init_ref
        # With chaining, the reference's fixed reseed cadence
        # (reinitialize_after, viso.h:20) would CAP the accumulated
        # baseline: deep in a corridor, parallax accumulates ~0.05
        # deg/frame and a 10-frame reseed can never reach the accept
        # gate (measured: a mid-run re-init stalled 300+ frames in a
        # reseed<->gate deadlock). The chain reseeds when it DIES
        # (track count below min_init_tracks, e.g. after a blackout)
        # and only otherwise at 4x the reference cadence.
        reseed = (
            ir is None
            or (self.frame_idx - ir[4]) >= 4 * cfg.reinitialize_after
        )
        if not reseed:
            ref_pyr, ref_kps, cur_kps, mask, ref_idx = ir
            kp2, err, ok = lk.track(self.last_pyr, pyr, cur_kps, mask)
            n_tracks = int(jnp.sum(ok))
            if n_tracks < cfg.min_init_tracks:
                reseed = True
            else:
                self.init_ref = (ref_pyr, ref_kps, kp2, ok, ref_idx)
        if reseed:
            uv, score, mask = self._detect(pyr)
            self.init_ref = (pyr, uv, uv, mask, self.frame_idx)
            # Anchor the segment at the ref frame's CURRENT pose: with
            # dead reckoning the pose advances during the blackout, and
            # the accepted two-view pose composes onto the ref-time
            # anchor. (Identical to the old behavior when the pose is
            # held: R/t never move during init without a _dr_fwd.)
            self.init_base = (self.R, self.t)
            return

        x1 = cam_mod.normalize(ref_kps, self.intr)
        x2 = cam_mod.normalize(kp2, self.intr)
        params = twoview.TwoViewParams(
            focal=cfg.fx,
            projection_error_thresh=cfg.init_projection_error_px,
            parallax_thresh_deg=cfg.init_parallax_deg,
            disparity_squared_thresh=cfg.disparity_squared_thresh,
        )
        res = twoview.initialize(self._next_key(), x1, x2, ok, params)
        disp_ok, n_inl, med_par = jax.device_get(
            (res.disparity_ok, res.num_inliers, res.median_parallax_deg)
        )
        if not bool(disp_ok):
            return
        # Rotation-compensated baseline gate: keep chaining until the
        # triangulated parallax supports a stable map (see
        # init_min_parallax_deg). The bar RELAXES with init age — every
        # uninitialized frame is dead reckoning, whose drift cost grows
        # linearly, while far scenes (deep corridor) may accumulate
        # parallax 10x slower than the gate's design point; a fixed bar
        # would trade unbounded drift for map quality. Floor at 1/6 of
        # the configured gate (still a real gate — r1-r4 had none).
        age = max(self.frame_idx - ref_idx, 1)
        eff_par = cfg.init_min_parallax_deg * min(
            1.0, cfg.reinitialize_after / age
        )
        eff_par = max(eff_par, cfg.init_min_parallax_deg / 6.0)
        if float(med_par) < eff_par:
            if os.environ.get("VISO_INIT_DEBUG") == "1":
                import sys

                print(
                    f"[init] f{self.frame_idx} ref f{ref_idx} GATED"
                    f" par={float(med_par):.2f}deg<{eff_par:.2f}"
                    f" inl={int(n_inl)}",
                    file=sys.stderr,
                )
            return
        n_inl = int(n_inl)
        # The inlier-RATIO gate also relaxes with age: chained LK
        # accumulates ~0.1 px/frame of drift, so a 20-40-frame chain
        # cannot hold the reference's 0.9 ratio (viso.cpp:76-77) even
        # when 100+ inliers fit the motion perfectly (measured: every
        # post-re-init chain on the deep corridor died here while the
        # engine dead-reckoned 300 frames). Absolute count still
        # applies; the floor keeps degenerate fits out.
        ratio_eff = max(
            0.6,
            cfg.min_init_inlier_ratio * min(1.0, cfg.reinitialize_after / age),
        )
        if n_inl < cfg.min_init_tracks or n_inl < ratio_eff * n_tracks:
            if os.environ.get("VISO_INIT_DEBUG") == "1":
                import sys

                print(
                    f"[init] f{self.frame_idx} ref f{ref_idx} INL-GATED"
                    f" inl={n_inl}/{n_tracks} ratio_eff={ratio_eff:.2f}",
                    file=sys.stderr,
                )
            return
        # Accept: promote both frames to keyframes (viso.cpp:79-98).
        # twoview works in the reference camera's frame (world == ref
        # cam); compose with the segment base pose so a re-init segment
        # continues the global trajectory.
        speed_prior = getattr(self, "_scale_prior", None)
        depth_prior = getattr(self, "_depth_prior", None)
        s_dbg = None
        if self.num_reinits > 0 and (
            depth_prior is not None or speed_prior is not None
        ):
            # Two independent scale anchors with COMPLEMENTARY failure
            # modes, cross-checked:
            #  * depth continuity (match the bootstrap's median inlier
            #    depth to the dying map's) is robust to the two-view's
            #    baseline/depth ratio error, but WRONG when the visible
            #    scene changed — a close-obstacle occlusion pass
            #    re-inits onto structure ~8x nearer (measured on the
            #    corridor bench: depth anchor alone re-entered at 1/8
            #    the true scale).
            #  * speed continuity (baseline = speed x gap) holds through
            #    both blackouts and occlusions, but inherits the
            #    two-view ratio error (up to ~2x at low parallax).
            # Agreement within 2.5x -> depth (better conditioned);
            # beyond -> the scene changed, trust speed.
            s_d = None
            if depth_prior is not None:
                z = np.asarray(res.points[:, 2])
                inl_np = np.asarray(res.inliers)
                med_boot = float(np.median(z[inl_np])) if inl_np.any() else 0.0
                if med_boot > 1e-9:
                    s_d = depth_prior / med_boot
            s_s = None
            if speed_prior is not None:
                gap = max(1, self.frame_idx - ref_idx)
                meas = float(np.linalg.norm(np.asarray(res.t)))
                if meas > 1e-9:
                    s_s = speed_prior * gap / meas
            s = blend_recovery_scale(s_d, s_s)
            if s is not None:
                res = res._replace(t=res.t * s, points=res.points * s)
                s_dbg = s
            self._scale_prior = None
            self._depth_prior = None
        if os.environ.get("VISO_INIT_DEBUG") == "1":
            import sys

            print(
                f"[init] f{self.frame_idx} ref f{ref_idx}"
                f" s={s_dbg if s_dbg is not None else 'none'}"
                f" depth_prior={depth_prior} speed_prior={speed_prior}"
                f" par={float(med_par):.2f}deg inl={n_inl}",
                file=sys.stderr,
            )
        Rb, tb = self.init_base
        R1, t1 = se3.compose(res.R, res.t, Rb, tb)
        Rb_inv, tb_inv = se3.inverse(Rb, tb)
        points_w = se3.transform(Rb_inv, tb_inv, res.points)
        slot0 = self._next_kf_slot()
        self.map = map_state.insert_keyframe(
            self.map, slot0, Rb, tb, ref_idx, ref_pyr
        )
        self.kf_order.append(slot0)
        slot1 = self._next_kf_slot()
        self.map = map_state.insert_keyframe(
            self.map, slot1, R1, t1, self.frame_idx, pyr
        )
        self.kf_order.append(slot1)
        self.map, slots, ok_alloc = map_state.allocate_landmarks(
            self.map, points_w, res.inliers
        )
        self.map = map_state.set_observations(self.map, slot0, slots, ref_kps, ok_alloc)
        self.map = map_state.set_observations(self.map, slot1, slots, kp2, ok_alloc)
        self.R, self.t = R1, t1
        self.prev_R, self.prev_t = Rb, tb
        # Velocity filter seed: the bootstrap's relative motion spans
        # `gap` chained frames — dividing its twist gives the PER-FRAME
        # velocity. (Leaving prev=ref would make the raw single-step
        # model predict gap x the true motion for the next frame.)
        gap_f = float(max(1, self.frame_idx - ref_idx))
        dR_b, dt_b = se3.relative(R1, t1, Rb, tb)
        self.vel_xi = se3.se3_log(dR_b, dt_b) / gap_f
        self.last_kf_frame = self.frame_idx
        self._refresh_templates(slot1)
        self.state = "tracking"
        self._post_keyframe(slot1, pyr)

    # -- keyframe insertion with new-landmark triangulation ------------
    def _build_mono_kf_kernel(self):
        """ONE jitted launch for the whole mono keyframe insertion:
        conditional eviction, keyframe + tracked-observation insert,
        FAST detection in the previous keyframe, LK track to the new
        frame, two-view triangulation with reprojection gates, landmark
        allocation, instead of ~30 eager device ops per keyframe."""
        cfg = self.cfg
        intr = self.intr
        per_cell = max(
            1, cfg.num_features // (cfg.detect_grid[0] * cfg.detect_grid[1])
        )
        from viso_tpu.geometry import triangulation as tri

        @jax.jit
        def insert(m, slot, do_evict, prev_slot, R, t, frame_id, pyr,
                   ok_align, refined):
            m_ev = map_state.evict_keyframe(m, slot)
            m = jax.tree.map(
                lambda a, b: jnp.where(do_evict, a, b), m_ev, m
            )
            prev_R = m.kf_R[prev_slot]
            prev_t = m.kf_t[prev_slot]
            prev_pyr = tuple(lvl[prev_slot] for lvl in m.kf_pyr)
            m = map_state.insert_keyframe(m, slot, R, t, frame_id, pyr)
            m = map_state.set_observations(
                m, slot, jnp.arange(cfg.max_landmarks), refined, ok_align
            )
            # New landmarks: detect in the previous keyframe image,
            # LK-track to the current frame, triangulate with the two
            # keyframe poses.
            if cfg.detect_levels > 1:
                uv_prev, score_prev, det_mask = fast.detect_grid_pyramid(
                    prev_pyr, threshold=cfg.fast_threshold,
                    grid=cfg.detect_grid, per_cell=per_cell,
                    levels=cfg.detect_levels,
                )
            else:
                uv_prev, score_prev, det_mask = fast.detect_grid(
                    prev_pyr[0], threshold=cfg.fast_threshold,
                    grid=cfg.detect_grid, per_cell=per_cell,
                )
            det_mask = det_mask & ~_near_existing(
                uv_prev, m.obs_uv[prev_slot], m.obs_mask[prev_slot], 8.0
            )
            uv_cur, err, ok_trk = lk.track(prev_pyr, pyr, uv_prev, det_mask)
            x1 = cam_mod.normalize(uv_prev, intr)
            x2 = cam_mod.normalize(uv_cur, intr)
            pts, d1, d2 = tri.triangulate(x1, x2, prev_R, prev_t, R, t)
            e1 = tri.reprojection_error(pts, x1, prev_R, prev_t)
            e2 = tri.reprojection_error(pts, x2, R, t)
            # Per-landmark parallax gate: at near-zero parallax, depth
            # is UNOBSERVABLE — the reprojection gate is depth-
            # insensitive along the ray, so midpoint triangulation
            # under pixel noise assigns essentially random (often tiny
            # or negative) depths that pass every other gate. Admitting
            # them poisons the map: measured on the forward-corridor
            # mono bench, far-wall junk drove the live map's median
            # landmark depth to 0.5 (5th pct NEGATIVE) in a 5-90 m
            # scene and tracking collapsed (46 -> 2 landmarks aligned).
            cosang = tri.parallax_cos(pts, prev_R, prev_t, R, t)
            enough_parallax = cosang < jnp.cos(
                jnp.deg2rad(cfg.min_triangulation_parallax_deg)
            )
            good = (
                ok_trk
                & (d1 > 0.05)
                & (d2 > 0.05)
                & enough_parallax
                & (e1 * cfg.fx < cfg.ransac_threshold_px)
                & (e2 * cfg.fx < cfg.ransac_threshold_px)
            )
            # FAR points: a low-parallax track's depth is unobservable,
            # but its BEARING is gold — far scene structure is what
            # anchors rotation (and a deep corridor may offer little
            # else; dropping these starved tracking within ~20 frames,
            # while admitting their junk depths poisoned the map).
            # Assign a stable far depth (2x the 90th-pct well-
            # triangulated depth) along the prev-KF ray; the wrong-but-
            # far depth biases translation by ~nothing (flow from t is
            # ~1/Z) and the cur-view reprojection gate still screens
            # mismatches.
            d_far = 2.0 * jnp.nanquantile(
                jnp.where(good, d1, jnp.nan), 0.9
            )
            # Fallback when this keyframe triangulated nothing (e.g. a
            # tracking crisis): stay RELATIVE to the existing map's
            # depth scale — an absolute constant here once injected far
            # points at ~12x the map's operating depth and blew the
            # segment scale up 10x mid-run.
            p_prev_cam = jnp.einsum("ij,nj->ni", prev_R, m.points) + prev_t
            d_map = jnp.nanmedian(
                jnp.where(m.point_mask, p_prev_cam[:, 2], jnp.nan)
            )
            d_far = jnp.where(jnp.isfinite(d_far), d_far, 4.0 * d_map)
            prev_c = -prev_R.T @ prev_t
            rays_w = (
                jnp.concatenate([x1, jnp.ones_like(x1[:, :1])], axis=-1)
                @ prev_R
            )   # R^T @ ray, rows: (N, 3)
            pts_far = prev_c[None, :] + d_far * rays_w
            e2_far = tri.reprojection_error(pts_far, x2, R, t)
            far_ok = (
                ok_trk
                & ~enough_parallax
                & jnp.isfinite(d_far)
                & (e2_far * cfg.fx < cfg.ransac_threshold_px)
            )
            pts = jnp.where(enough_parallax[:, None], pts, pts_far)
            good = good | far_ok
            m, slots, ok_alloc = map_state.allocate_landmarks(m, pts, good)
            m = map_state.set_observations(m, prev_slot, slots, uv_prev, ok_alloc)
            m = map_state.set_observations(m, slot, slots, uv_cur, ok_alloc)
            return m

        return insert

    def _insert_mono_keyframe(self, pyr, existing_obs):
        cfg = self.cfg
        ok_align, refined = existing_obs
        prev_slot = self.kf_order[-1]
        evict = len(self.kf_order) >= cfg.max_keyframes
        slot = self._next_kf_slot_peek()
        self.kf_order.append(slot)
        if "mono_kf" not in self._kernels:
            self._kernels["mono_kf"] = self._build_mono_kf_kernel()
        self.map = self._kernels["mono_kf"](
            self.map, slot, jnp.asarray(evict), prev_slot,
            self.R, self.t, self.frame_idx, pyr, ok_align, refined,
        )


def blend_recovery_scale(s_d, s_s, agree=2.5, lo=0.05, hi=20.0):
    """Cross-check the two recovery scale anchors (see _try_initialize).

    s_d: depth-continuity estimate (robust to the two-view ratio error,
    wrong across occlusions); s_s: speed-continuity estimate (holds
    through occlusions, carries the ratio error). Agreement within
    `agree`x picks depth; disagreement picks speed; either may be None.
    Returns a clipped float or None."""
    if s_d is not None and s_s is not None:
        ratio = s_d / s_s
        s = s_d if 1.0 / agree < ratio < agree else s_s
    else:
        s = s_d if s_d is not None else s_s
    if s is None:
        return None
    return float(np.clip(s, lo, hi))


def _pull_poses(results):
    """Stack per-frame (R, t) device arrays and pull them in ONE D2H.

    jnp.stack accepts a mix of device and host arrays, so results
    recorded before/after a checkpoint restore both work.
    """
    if not results:
        return (
            np.zeros((0, 3, 3), np.float32), np.zeros((0, 3), np.float32)
        )
    R = np.asarray(jnp.stack([r.R for r in results]))
    t = np.asarray(jnp.stack([r.t for r in results]))
    return R.astype(np.float32), t.astype(np.float32)


def _top_m_by_score(good, score, m):
    """Keep at most `m` True entries of `good`, highest `score` first."""
    s = jnp.where(good, score, -jnp.inf)
    rank = jnp.argsort(jnp.argsort(-s))
    return good & (rank < m)


@jax.jit
def _near_existing(uv, existing_uv, existing_mask, radius=8.0):
    """Mask of `uv` entries within `radius` px of any valid existing point."""
    d = jnp.linalg.norm(uv[:, None, :] - existing_uv[None, :, :], axis=-1)
    d = jnp.where(existing_mask[None, :], d, jnp.inf)
    return jnp.min(d, axis=-1) < radius
