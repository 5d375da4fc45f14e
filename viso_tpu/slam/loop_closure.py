"""Loop-closure detection and pose-graph correction.

No reference counterpart (SURVEY.md §2 — the reference has neither
descriptors nor a pose graph); this implements the north-star loop
pipeline (BASELINE.json config 4):

  1. Every keyframe contributes a fixed-size BRIEF descriptor set to a
     fixed-capacity database (SoA, so candidate scoring against ALL
     stored keyframes is one big matmul batch).
  2. Candidates = keyframes (outside a temporal guard window) whose
     descriptor match count clears a threshold.
  3. Geometric verification: PnP RANSAC of the candidate keyframe's
     stored 3-D landmarks against the current keyframe's matched 2-D
     features -> relative pose measurement.
  4. The verified edge joins the pose graph; backend/pose_graph.solve
     redistributes the drift.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from viso_tpu.geometry import camera as cam_mod
from viso_tpu.geometry import se3
from viso_tpu.ops import descriptors, pnp

import os

# VISO_LOOP_DEBUG=1 prints every candidate's gate record to stderr.
_DEBUG_ENV = os.environ.get("VISO_LOOP_DEBUG") == "1"


@dataclass
class LoopParams:
    capacity: int = 256            # stored keyframes
    num_features: int = 256        # descriptors per keyframe
    guard: int = 30                # skip this many most-recent keyframes
    min_matches: int = 40          # descriptor matches to be a candidate
    min_inliers: int = 30          # PnP inliers to accept
    # Reprojection gate in PIXELS (normalized per-camera at detect time):
    # independently re-detected FAST corners land 1-2 px apart across
    # views, so this must be looser than the tracking gates.
    pnp_threshold_px: float = 4.0
    # Plausibility gate on the implied correction: a verified-but-ALIASED
    # loop (self-similar walls) yanks the whole world by the aliasing
    # offset and kills tracking. The measured relative pose may disagree
    # with the current odometry estimate by accumulated drift — which
    # GROWS with distance traveled since the candidate was stored. The
    # round-2 fixed bounds failed both ways at benchmark scale: tight
    # bounds rejected every true loop once drift exceeded them, loose
    # bounds admitted along-the-wall aliases once drift shrank. The gate
    # is therefore DRIFT-SCALED: the allowed disagreement is
    #   trans: base_correction_m  + trans_drift_rate * path_since_cand
    #   rot:   base_correction_rad + rot_drift_rate  * rot_since_cand
    # (path/rot = odometry arc-length integrals stored per entry),
    # clamped above by the hard ceilings max_correction_m/rad. The
    # default rates are ~5% drift per unit traveled — an order of
    # magnitude above a healthy front-end, far below aliasing offsets.
    base_correction_m: float = 0.3
    base_correction_rad: float = 0.05
    trans_drift_rate: float = 0.05     # m disagreement per m traveled
    rot_drift_rate: float = 0.05       # rad per rad integrated rotation
    max_correction_m: float = 10.0
    max_correction_rad: float = 1.2
    # A loop whose interval CROSSES a dead-reckoning seam relaxes to
    # the hard ceilings when its PnP evidence is at least this multiple
    # of min_inliers: the seam's error is unobserved and can exceed any
    # rate-based budget (a reinit's re-convergence error is not bounded
    # by the blackout span), so for these loops geometric evidence is
    # the only usable signal. 0 disables.
    seam_evidence_factor: float = 1.5
    # Overwhelming measurement evidence (inliers >= this multiple of
    # min_inliers) overrides the scaled bound up to the hard ceilings.
    # DISABLED by default (0): measured on the orbit benchmark,
    # self-similar texture produces 70+-inlier PnP fits at aliased
    # locations, so inlier count alone cannot authorize a correction
    # beyond the drift budget. Set > 0 only for environments with
    # globally distinctive appearance.
    evidence_override: float = 0.0
    # GRADED evidence scaling of the drift budget: the budget is
    # multiplied by clamp(inliers / min_inliers, 1, this cap). Unlike
    # evidence_override this never authorizes more than cap x the
    # rate-based budget, so room-scale aliases (offsets many x budget)
    # stay out while true loops under DEGRADED drift (measured ~2x the
    # clean rate under exposure drift + noise + blur, putting d_trans
    # 2-20% past the budget with 1.2-2x min_inliers of evidence) get
    # through. The widened solve-health gate (max correction over ALL
    # nodes) backstops anything this admits. 0 disables.
    evidence_boost_cap: float = 1.6
    # Pose-graph optimization fires at most once per this many keyframe
    # insertions (loop edges still join the graph immediately and are
    # incorporated at the next event): per-keyframe event storms churn
    # the world faster than the tracker re-converges.
    min_event_gap_kf: int = 3
    # Retention policy once the DB is full. The most recent
    # `retain_recent` insertions are NEVER evicted (a recency-complete
    # short-term tier for drift-scale loops); beyond that the victim is
    # the most SPATIALLY REDUNDANT entry — smallest camera-center
    # distance to its nearest stored neighbor — so old but spatially
    # distinct places survive indefinitely and loops spanning far more
    # than `capacity` keyframes stay closable (a pure-recency ring
    # silently lost any loop older than capacity keyframes; VERDICT r3
    # missing #1). retain_recent >= capacity degenerates to the pure
    # recency ring.
    retain_recent: int = 64


class LoopCandidate(NamedTuple):
    db_index: int       # caller-supplied external id (pose-graph node)
    matches: int
    inliers: int
    R_rel: np.ndarray   # measured T_cur * T_cand^-1
    t_rel: np.ndarray
    # Monocular: measured relative SCALE between the candidate's and the
    # current segment's local metrics (Sim3 edge; 1.0 for stereo).
    s_rel: float = 1.0


class LoopDatabase:
    """Fixed-capacity store of keyframe descriptor sets + geometry.

    When full, eviction is two-tier: the most recent `retain_recent`
    insertions are protected (recency-complete short-term tier — the
    right policy for drift-correcting loops), and among the rest the
    most spatially redundant entry is recycled (smallest camera-center
    distance to its nearest stored neighbor, newest of a redundant pair
    first). Old, spatially distinct places therefore survive
    indefinitely: loops spanning far more than `capacity` keyframes —
    KITTI-00's signature large loops — stay closable. Entries carry a
    caller-supplied `node_id` (pose-graph node index) so candidates stay
    addressable after slots are recycled. Realizes the bounded-map
    intent of the reference's unused RingBuffer
    (/root/reference/include/ring_buffer.h:10-42) without the
    lose-the-biggest-loops failure of pure recency.
    """

    def __init__(self, params: LoopParams, seed: int = 0):
        p = params
        self.params = p
        self.desc = jnp.zeros(
            (p.capacity, p.num_features, descriptors.DESC_BITS), jnp.bfloat16
        )
        self.desc_mask = jnp.zeros((p.capacity, p.num_features), bool)
        self.kp_uv = np.zeros((p.capacity, p.num_features, 2), np.float32)
        self.points_w = np.zeros((p.capacity, p.num_features, 3), np.float32)
        self.points_ok = np.zeros((p.capacity, p.num_features), bool)
        # Device mirrors of the landmark geometry: the fused detect
        # kernel (detect_fused) runs match scoring AND PnP verification
        # on device in one launch, so candidate landmarks must already
        # live there — re-uploading per detection would serialize an
        # H2D into every loop check.
        self.points_w_dev = jnp.zeros(
            (p.capacity, p.num_features, 3), jnp.float32
        )
        self.points_ok_dev = jnp.zeros((p.capacity, p.num_features), bool)
        self.R = np.zeros((p.capacity, 3, 3), np.float32)
        self.t = np.zeros((p.capacity, 3), np.float32)
        self.frame_id = np.full(p.capacity, -1, np.int64)
        self.node_id = np.full(p.capacity, -1, np.int64)
        # Odometry arc-length integrals (translation meters, rotation
        # radians) at insertion time — the drift-scaled gate's clock.
        self.path_len = np.zeros(p.capacity, np.float32)
        self.rot_len = np.zeros(p.capacity, np.float32)
        # Dead-reckoning seam allowances (meters / radians) at insertion
        # time: unobserved motion during tracking blackouts is REAL
        # drift the plausibility gate must budget for at full magnitude
        # (the drift-RATE budget only opens ~5% of it, which rejected
        # every loop closing across a recovery seam).
        self.seam_t = np.zeros(p.capacity, np.float32)
        self.seam_r = np.zeros(p.capacity, np.float32)
        # Optional gate diagnostics: set to a list to record every
        # candidate's gate inputs and decision (tools/diag_loops.py).
        self.debug: Optional[list] = None
        # Monotonic insertion counter; per-slot insertion stamp drives
        # both ring replacement and the temporal guard window.
        self.total = 0
        self.insert_seq = np.full(p.capacity, -1, np.int64)
        self.key = jax.random.PRNGKey(seed)
        self._evict_rng = np.random.default_rng(seed + 0x5EED)

    @property
    def count(self) -> int:
        """Live entries (== capacity once the ring has wrapped)."""
        return min(self.total, self.params.capacity)

    def add(self, img_smooth, kps, kp_mask, points_w, points_ok, R, t,
            frame_id, node_id=-1, path_len=0.0, rot_len=0.0, desc=None,
            seam_t=0.0, seam_r=0.0):
        """Store a keyframe: descriptors at `kps`, its pose, the 3-D
        landmarks associated with those keypoints (points_ok marks
        which), the caller's external `node_id`, and the odometry
        arc-length integrals at insertion (for the drift-scaled gate).
        `desc` may carry precomputed descriptors (the engine's keyframe
        digest kernel computes them inline with the insert — recomputing
        here would double the descriptor work per keyframe).
        Returns the slot written (most spatially redundant unprotected
        entry recycled once full)."""
        if self.total < self.params.capacity:
            i = self.total
        else:
            i = self._evict_slot()
        if desc is None:
            desc = descriptors.compute(img_smooth, kps, kp_mask)
        # Device-side stores are async dispatches; the host mirrors
        # below are what may block (callers pre-start their D2H).
        self.desc = self.desc.at[i].set(desc)
        self.desc_mask = self.desc_mask.at[i].set(kp_mask)
        self.points_w_dev = self.points_w_dev.at[i].set(
            jnp.asarray(points_w, jnp.float32)
        )
        self.points_ok_dev = self.points_ok_dev.at[i].set(
            jnp.asarray(points_ok)
        )
        self.kp_uv[i] = np.asarray(kps)
        self.points_w[i] = np.asarray(points_w)
        self.points_ok[i] = np.asarray(points_ok)
        self.R[i] = np.asarray(R)
        self.t[i] = np.asarray(t)
        self.frame_id[i] = frame_id
        self.node_id[i] = node_id if node_id >= 0 else self.total
        self.path_len[i] = path_len
        self.rot_len[i] = rot_len
        self.seam_t[i] = seam_t
        self.seam_r[i] = seam_r
        self.insert_seq[i] = self.total
        self.total += 1
        return i

    def _evict_slot(self) -> int:
        """Pick the slot to recycle: most spatially redundant entry
        outside the protected recent tier.

        Redundancy = camera-center distance to the nearest OTHER stored
        entry; the evictable entry minimizing it is the one whose place
        the database can best afford to forget. Ties (co-located
        entries) evict the NEWER one — the older entry's landmarks are
        what the longest loops verify against. O(capacity^2) NumPy per
        insertion: 256^2 = 65k distances, microseconds host-side."""
        p = self.params
        seq = self.insert_seq
        protected = seq > self.total - 1 - p.retain_recent
        evictable = np.nonzero(~protected)[0]
        if len(evictable) == 0:
            # retain_recent >= capacity: pure recency ring.
            return int(np.argmin(seq))
        if len(evictable) == 1:
            return int(evictable[0])
        # Redundancy is measured against the LONG-TERM set ONLY: the
        # recent tier is transient, and counting it makes every newly
        # aged-out entry look redundant (it is ~1 keyframe-step from
        # its protected successor), which starves the long-term tier of
        # everything but the initial prefix (measured: a 256-step
        # corridor retained [0..22] + recents, max gap 229; excluding
        # the tier yields near-uniform extent/capacity coverage).
        centers = -np.einsum("nji,nj->ni", self.R, self.t)
        c_ev = centers[evictable]
        d = np.linalg.norm(c_ev[:, None, :] - c_ev[None, :, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        ds = np.sort(d, axis=1)
        # Removal harm ~ sum of the two nearest-neighbor distances (the
        # gap the eviction opens); endpoints score high and survive.
        harm = ds[:, 0] + ds[:, 1]
        # Multiplicative jitter breaks the exact ties of uniform
        # spacing (deterministic tie-breaks freeze one region and
        # starve another); order between distinct harms is preserved.
        harm = harm * (1.0 + 0.01 * self._evict_rng.random(len(evictable)))
        return int(evictable[int(np.argmin(harm))])

    def detect(self, img_smooth, kps, kp_mask, R_cur, t_cur, intr,
               path_len=None, rot_len=None) -> Optional[LoopCandidate]:
        """Look for a verified loop closure for the current keyframe."""
        desc_q = descriptors.compute(img_smooth, kps, kp_mask)
        return self.detect_fused(
            desc_q, jnp.asarray(kps), kp_mask, R_cur, t_cur, intr,
            path_len=path_len, rot_len=rot_len,
        )

    def detect_fused_sim3(self, desc_q, kps, kp_mask, pts_q, pts_q_ok,
                          R_cur, t_cur, intr, path_len=None,
                          rot_len=None, seam_t=None,
                          seam_r=None) -> Optional[LoopCandidate]:
        """Monocular loop detection: like detect_fused, plus a masked-
        Umeyama relative Sim(3) fit over the PnP inliers so the edge
        carries the scale ratio between the candidate's and the current
        segment's local metrics (mono scale drift is exactly what the
        Sim3 pose graph redistributes). One jitted launch, one D2H."""
        p = self.params
        eligible = (self.insert_seq >= 0) & (
            self.insert_seq <= self.total - 1 - p.guard
        )
        if not eligible.any():
            return None
        self.key, sub = jax.random.split(self.key)
        thresh = (p.pnp_threshold_px / float(intr.fx)) ** 2
        packed = np.asarray(
            _detect_fused_sim3_kernel(
                desc_q, kp_mask, kps, pts_q, pts_q_ok,
                jnp.asarray(R_cur), jnp.asarray(t_cur),
                self.desc, self.desc_mask,
                self.points_w_dev, self.points_ok_dev,
                jnp.asarray(eligible), intr,
                jnp.asarray(thresh, jnp.float32),
                jnp.asarray(p.min_matches, jnp.int32),
                jnp.asarray(p.min_inliers, jnp.int32),
                sub,
            )
        )
        s_g = float(packed[16])
        R_g = packed[17:26].reshape(3, 3).astype(np.float32)
        t_g = packed[26:29].astype(np.float32)
        cand = self._gate_packed(
            packed, R_cur, t_cur, path_len, rot_len, seam_t, seam_r
        )
        if cand is None:
            return None
        # Scale plausibility: a similarity fit implying more than
        # max_scale_log of log-scale disagreement marks a degenerate
        # geometry (near-planar inlier set), not believable drift.
        if abs(np.log(max(s_g, 1e-6))) > 0.7:
            if _DEBUG_ENV:
                import sys

                print(
                    f"[loop-stage] implausible scale ratio {s_g:.3f}",
                    file=sys.stderr,
                )
            return None
        # The Umeyama G IS the graph edge measurement S_i o S_j^-1
        # (cam_j-local -> cam_i-local coordinate change).
        return cand._replace(
            s_rel=s_g, R_rel=R_g, t_rel=t_g
        )

    def detect_fused(self, desc_q, kps, kp_mask, R_cur, t_cur, intr,
                     path_len=None, rot_len=None, seam_t=None,
                     seam_r=None) -> Optional[LoopCandidate]:
        """Loop detection with precomputed query descriptors.

        The whole device side — capacity-wide match scoring, best-
        candidate matching, and PnP RANSAC verification — is ONE jitted
        launch returning a 16-float packed result, so the worker pays a
        single D2H round-trip per detection, instead of pulling counts,
        matches, and the PnP result separately (~5 blocking round-trips
        per detection).
        """
        p = self.params
        # Temporal guard: skip the `guard` most recent insertions.
        eligible = (self.insert_seq >= 0) & (
            self.insert_seq <= self.total - 1 - p.guard
        )
        if not eligible.any():
            return None
        self.key, sub = jax.random.split(self.key)
        thresh = (p.pnp_threshold_px / float(intr.fx)) ** 2
        packed = np.asarray(
            _detect_fused_kernel(
                desc_q, kp_mask, kps, self.desc, self.desc_mask,
                self.points_w_dev, self.points_ok_dev,
                jnp.asarray(eligible), intr,
                jnp.asarray(thresh, jnp.float32),
                jnp.asarray(p.min_matches, jnp.int32),
                jnp.asarray(p.min_inliers, jnp.int32),
                sub,
            )
        )
        return self._gate_packed(
            packed, R_cur, t_cur, path_len, rot_len, seam_t, seam_r
        )


    def _gate_packed(self, packed, R_cur, t_cur, path_len, rot_len,
                     seam_t=None, seam_r=None):
        """Shared host-side gating of a packed detect-kernel result:
        match/inlier thresholds, then the drift-scaled plausibility
        bound on the implied correction."""
        p = self.params
        best_matches = int(packed[0])
        best = int(packed[1])
        n_3d = int(packed[2])
        n_inl = int(packed[3])
        R_meas = packed[4:13].reshape(3, 3).astype(np.float32)
        t_meas = packed[13:16].astype(np.float32)
        if best_matches < p.min_matches:
            if _DEBUG_ENV:
                import sys

                print(
                    f"[loop-stage] best_matches={best_matches} < "
                    f"min_matches={p.min_matches} (cand node "
                    f"{int(self.node_id[best])})", file=sys.stderr,
                )
            return None
        if n_3d < p.min_inliers:
            if _DEBUG_ENV:
                import sys

                print(
                    f"[loop-stage] matched-with-3d={n_3d} < "
                    f"min_inliers={p.min_inliers}", file=sys.stderr,
                )
            return None
        if n_inl < p.min_inliers:
            if _DEBUG_ENV:
                import sys

                print(
                    f"[loop-stage] pnp_inliers={n_inl} < "
                    f"min_inliers={p.min_inliers}", file=sys.stderr,
                )
            return None
        # Host-side NumPy from here: 3x3 pose algebra per candidate is
        # microseconds on host but each jnp op would be a device
        # dispatch from the worker thread.
        R_cur = np.asarray(R_cur)
        t_cur = np.asarray(t_cur)
        R_db, t_db = self.R[best], self.t[best]
        # Measured relative: T_meas o T_db^-1.
        R_rel = R_meas @ R_db.T
        t_rel = t_meas - R_rel @ t_db
        # Plausibility: measured relative vs the current odometry
        # estimate. Disagreement = accumulated drift (fine, that is what
        # the loop corrects) — unless it exceeds the configured bounds,
        # which marks a visually-aliased false positive.
        R_est = R_cur @ R_db.T
        t_est = t_cur - R_est @ t_db
        dR = R_rel.T @ R_est
        dt = R_rel.T @ (t_est - t_rel)
        d_trans = float(np.linalg.norm(dt))
        d_rot = float(
            np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        )
        # Drift-scaled bounds: the disagreement a TRUE loop may show is
        # the drift accrued since the candidate was stored, which grows
        # with traveled path / integrated rotation — not a constant.
        if path_len is not None:
            dpath = max(0.0, float(path_len) - float(self.path_len[best]))
        else:
            dpath = None
        if rot_len is not None:
            drot_i = max(0.0, float(rot_len) - float(self.rot_len[best]))
        else:
            drot_i = None
        bound_m = p.max_correction_m
        bound_rad = p.max_correction_rad
        if dpath is not None:
            bound_m = min(
                bound_m, p.base_correction_m + p.trans_drift_rate * dpath
            )
        if drot_i is not None:
            bound_rad = min(
                bound_rad, p.base_correction_rad + p.rot_drift_rate * drot_i
            )
        # Dead-reckoning seams since the candidate was stored enter the
        # budget at FULL magnitude (capped by the hard ceilings below):
        # the motion during a blackout is entirely unobserved, so the
        # whole allowance is legitimate disagreement for a true loop.
        if seam_t is not None:
            bound_m = min(
                p.max_correction_m,
                bound_m + max(0.0, float(seam_t) - float(self.seam_t[best])),
            )
        if seam_r is not None:
            bound_rad = min(
                p.max_correction_rad,
                bound_rad
                + max(0.0, float(seam_r) - float(self.seam_r[best])),
            )
        # GRADED evidence boost: the drift budget assumes clean-
        # condition drift rates, but degraded conditions (exposure
        # drift + noise + blur) double the real drift — and exactly
        # those early, high-value loops then show d_trans just past the
        # budget while carrying 1.5-2x the minimum inlier evidence
        # (measured on the degraded orbit bench: 5 true loops rejected
        # at d_trans 1.04-1.24 vs bound ~1.02 with 48-82 inliers).
        # Scale the budget by the evidence ratio, capped, never past
        # the hard ceilings.
        if p.evidence_boost_cap > 0 and p.min_inliers > 0:
            boost = max(
                1.0, min(p.evidence_boost_cap, n_inl / p.min_inliers)
            )
            bound_m = min(p.max_correction_m, bound_m * boost)
            bound_rad = min(p.max_correction_rad, bound_rad * boost)
        # Overwhelming evidence: geometry this strong overrides the
        # scaled bound (but never the hard ceiling). Off by default.
        if p.evidence_override > 0 and n_inl >= p.evidence_override * p.min_inliers:
            bound_m = p.max_correction_m
            bound_rad = p.max_correction_rad
        # Seam-crossing loops: trust strong geometric evidence up to
        # the hard ceilings (see LoopParams.seam_evidence_factor).
        if (
            p.seam_evidence_factor > 0
            and seam_t is not None
            and float(seam_t) - float(self.seam_t[best]) > 1e-6
            and n_inl >= p.seam_evidence_factor * p.min_inliers
        ):
            bound_m = p.max_correction_m
            bound_rad = p.max_correction_rad
        accept = d_trans <= bound_m and d_rot <= bound_rad
        if self.debug is not None or _DEBUG_ENV:
            rec = dict(
                cand_node=int(self.node_id[best]),
                matches=best_matches, inliers=n_inl,
                d_trans=d_trans, d_rot=d_rot,
                dpath=dpath, drot=drot_i,
                bound_m=bound_m, bound_rad=bound_rad, accept=accept,
            )
            if self.debug is not None:
                self.debug.append(rec)
            if _DEBUG_ENV:
                import sys

                print(f"[loop-gate] {rec}", file=sys.stderr)
        if not accept:
            return None
        return LoopCandidate(
            db_index=int(self.node_id[best]),
            matches=best_matches,
            inliers=n_inl,
            R_rel=np.asarray(R_rel),
            t_rel=np.asarray(t_rel),
        )


@jax.jit
def _match_counts(desc_q, mask_q, desc_db, mask_db):
    """Number of mutual ratio-test matches against each stored keyframe."""

    def one(desc_k, mask_k):
        _, _, ok = descriptors.match(desc_q, mask_q, desc_k, mask_k)
        return jnp.sum(ok)

    return jax.vmap(one)(desc_db, mask_db)


@jax.jit
def _detect_fused_sim3_kernel(
    desc_q, mask_q, kps_q, pts_q, pts_q_ok, R_cur, t_cur,
    desc_db, mask_db, pts_db, pts_ok_db,
    eligible, intr, thresh, min_matches, min_inliers, key,
):
    """Monocular variant of _detect_fused_kernel: additionally fits the
    relative Sim(3) between the candidate's and the current segment's
    local metrics, via a masked Umeyama over the PnP inliers' CAMERA-
    frame coordinates (candidate landmarks through the PnP pose vs the
    current keyframe's own landmarks through its odometry pose — the
    same physical points in the same camera, expressed in two scales).
    Packed: [matches, slot, n3d, inliers, R_pnp(9), t_pnp(3),
             s_g, R_g(9), t_g(3)] (29 floats, one D2H)."""
    from viso_tpu.geometry import sim3

    counts = _match_counts(desc_q, mask_q, desc_db, mask_db)
    counts = jnp.where(eligible, counts, -1)
    best = jnp.argmax(counts)
    idx2, _, ok = descriptors.match(
        desc_q, mask_q, desc_db[best], mask_db[best]
    )
    ok = ok & pts_ok_db[best][idx2]
    n_3d = jnp.sum(ok)
    pts3d = pts_db[best][idx2]
    x = cam_mod.normalize(kps_q, intr)
    is_cand = (counts[best] >= min_matches) & (n_3d >= min_inliers)

    def run_pnp(_):
        res = pnp.pnp_ransac(key, pts3d, x, ok, threshold=thresh)
        p_i = se3.transform(res.R, res.t, pts3d)
        p_j = se3.transform(R_cur, t_cur, pts_q)
        m = res.inliers & ok & pts_q_ok
        s_g, R_g, t_g = sim3.umeyama_masked(p_j, p_i, m)
        return res, s_g, R_g, t_g

    def skip_pnp(_):
        return (
            pnp.PnPResult(
                jnp.eye(3, dtype=jnp.float32),
                jnp.zeros(3, jnp.float32),
                jnp.zeros_like(ok),
                jnp.asarray(0, jnp.int32),
            ),
            jnp.asarray(1.0, jnp.float32),
            jnp.eye(3, dtype=jnp.float32),
            jnp.zeros(3, jnp.float32),
        )

    res, s_g, R_g, t_g = jax.lax.cond(is_cand, run_pnp, skip_pnp, None)
    head = jnp.stack(
        [
            counts[best].astype(jnp.float32),
            best.astype(jnp.float32),
            n_3d.astype(jnp.float32),
            res.num_inliers.astype(jnp.float32),
        ]
    )
    return jnp.concatenate(
        [head, res.R.reshape(-1), res.t, s_g[None], R_g.reshape(-1), t_g]
    )


@jax.jit
def _detect_fused_kernel(
    desc_q, mask_q, kps_q, desc_db, mask_db, pts_db, pts_ok_db,
    eligible, intr, thresh, min_matches, min_inliers, key,
):
    """Whole detection pipeline in one launch: capacity-wide match
    scoring -> best candidate -> per-match association -> PnP RANSAC.

    Returns a 16-float packed vector
    [best_matches, best_slot, n_matched_with_3d, pnp_inliers, R(9), t(3)]
    so the caller pays exactly one D2H round-trip. PnP (the expensive
    stage: 512 vmapped DLT hypotheses + robust GN) runs under lax.cond
    only when the match gates pass — most keyframes have no candidate,
    and paying RANSAC for them would tax every keyframe's device time.
    """
    counts = _match_counts(desc_q, mask_q, desc_db, mask_db)
    counts = jnp.where(eligible, counts, -1)
    best = jnp.argmax(counts)
    idx2, _, ok = descriptors.match(
        desc_q, mask_q, desc_db[best], mask_db[best]
    )
    ok = ok & pts_ok_db[best][idx2]
    n_3d = jnp.sum(ok)
    pts3d = pts_db[best][idx2]
    x = cam_mod.normalize(kps_q, intr)
    is_cand = (counts[best] >= min_matches) & (n_3d >= min_inliers)

    def run_pnp(_):
        return pnp.pnp_ransac(key, pts3d, x, ok, threshold=thresh)

    def skip_pnp(_):
        return pnp.PnPResult(
            jnp.eye(3, dtype=jnp.float32),
            jnp.zeros(3, jnp.float32),
            jnp.zeros_like(ok),
            jnp.asarray(0, jnp.int32),
        )

    res = jax.lax.cond(is_cand, run_pnp, skip_pnp, None)
    head = jnp.stack(
        [
            counts[best].astype(jnp.float32),
            best.astype(jnp.float32),
            n_3d.astype(jnp.float32),
            res.num_inliers.astype(jnp.float32),
        ]
    )
    return jnp.concatenate([head, res.R.reshape(-1), res.t])
