"""Stress the asynchronous stats control loop with randomized delays.

The engine makes keyframe / lost-tracking decisions from stats samples
fetched by background reader threads (engine.py:_track_landmarks); a
slow device-to-host readback lands them frames late. These tests inject
RANDOMIZED artificial delays (0-10 frames) into the fetch pipeline and
assert the control loop's guarantees still hold.

Worst-case staleness bound (analytical): every in-flight fetch is
force-joined once it is `stats_hard_lag` frames old (default
max(2, stats_max_lag) on every backend), so a sample is at most that
many frames old when consumed, and the cached decision value at most
~2x that (one join interval after its consumption). Injected delays
beyond the hard bound are cut short by the join. Decisions additionally
ignore samples older than the newest keyframe (_stats_fresh), so a
stale pre-insert sample can never re-trigger recovery or keyframe
insertion, and the gap-based keyframe schedule (kf_max_gap) is
independent of stats entirely — cadence degrades to the bounded schedule
under unbounded delay, never stalls.
"""

import concurrent.futures

import numpy as np
import pytest

from viso_tpu.data import synthetic
from viso_tpu.geometry import camera
from viso_tpu.slam.engine import StereoVO, VOConfig
from viso_tpu.utils import metrics

H, W = 192, 256
INTR = dict(fx=200.0, fy=200.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)


class _DelayedFuture:
    """Reports done() only once the engine has advanced `delay` frames
    past submission (simulates a slow D2H readback)."""

    def __init__(self, fut, vo, release_frame):
        self._fut = fut
        self._vo = vo
        self._release = release_frame

    def done(self):
        return self._vo.frame_idx >= self._release and self._fut.done()

    def result(self):
        return self._fut.result()


class _DelayedExecutor:
    def __init__(self, vo, rng, max_delay):
        self._inner = concurrent.futures.ThreadPoolExecutor(max_workers=4)
        self._vo = vo
        self._rng = rng
        self._max_delay = max_delay

    def submit(self, fn, *args):
        fut = self._inner.submit(fn, *args)
        delay = int(self._rng.integers(0, self._max_delay + 1))
        return _DelayedFuture(fut, self._vo, self._vo.frame_idx + delay)

    def shutdown(self, **kw):
        self._inner.shutdown(wait=False)


def _make_vo(rng, max_delay, **kw):
    cfg = VOConfig(
        height=H, width=W, max_keyframes=6, max_landmarks=384,
        num_features=192, detect_grid=(4, 6), fast_threshold=15.0,
        baseline=0.3, max_disparity=48, kf_min_gap=2, kf_max_gap=8,
        stats_max_lag=4, **INTR, **kw,
    )
    vo = StereoVO(cfg)
    # Install the delayed pipeline before the lazy init in
    # _track_landmarks creates the real one.
    vo._pending_stats_q = []
    vo._stats_reader = _DelayedExecutor(vo, rng, max_delay)
    return vo


@pytest.fixture(scope="module")
def corridor():
    rng = np.random.default_rng(7)
    return synthetic.corridor_scene(rng, tex_size=512)


def _render(corridor, n, step=0.2):
    intr = camera.Intrinsics.create(**INTR)
    Rs, ts = synthetic.forward_trajectory(n, step=step, yaw_rate=0.004)
    frames = [
        synthetic.make_stereo_pair(corridor, intr, R, t, H, W, baseline=0.3)[:2]
        for R, t in zip(Rs, ts)
    ]
    return frames, (Rs, ts)


def test_keyframe_cadence_under_random_delay(corridor):
    n = 60
    frames, (Rs, ts) = _render(corridor, n)
    vo = _make_vo(np.random.default_rng(3), max_delay=10)
    for il, ir in frames:
        vo.process(il, ir)
    kf_frames = [i for i, r in enumerate(vo.results) if r.is_keyframe]
    # The gap-based schedule must hold regardless of stats lag.
    gaps = np.diff(kf_frames)
    assert gaps.max() <= vo.cfg.kf_max_gap, (kf_frames, gaps)
    assert gaps.min() >= vo.cfg.kf_min_gap
    # And tracking accuracy must not degrade materially (bound sized
    # for the direct_iters=6 default over this 12 m path; the zero-delay
    # integration test pins the tight accuracy gate).
    R_est, t_est = vo.trajectory()
    c_est = metrics.camera_centers(R_est, t_est)
    c_gt = metrics.camera_centers(Rs, ts)
    ate = metrics.ate_rmse(c_est, c_gt, align=True, with_scale=False)
    assert ate < 0.08, ate
    vo.close()


def test_lost_recovery_under_random_delay(corridor):
    # A mid-run blackout with delayed stats: recovery may arrive late
    # (bounded by stats_max_lag + max_delay + lost_reinit_after) but the
    # run must re-acquire and the trajectory stay finite and accurate
    # after recovery.
    n = 70
    frames, (Rs, ts) = _render(corridor, n)
    vo = _make_vo(np.random.default_rng(5), max_delay=6)
    blackout = range(30, 34)
    for i, (il, ir) in enumerate(frames):
        if i in blackout:
            il = np.zeros_like(il)
            ir = np.zeros_like(ir)
        vo.process(il, ir)
    R_est, t_est = vo.trajectory()
    assert np.isfinite(np.asarray(t_est)).all()
    # Post-recovery segment: bounded metric error.
    idx = list(range(48, n))
    c_est = metrics.camera_centers(R_est[idx], t_est[idx])
    c_gt = metrics.camera_centers(Rs[idx], ts[idx])
    ate = metrics.ate_rmse(c_est, c_gt, align=True, with_scale=False)
    assert ate < 0.12, ate
    vo.close()


def test_staleness_never_rolls_back_decisions(corridor):
    # With an extreme fixed delay (every sample 10 frames late) the
    # engine must not spin on stale pre-keyframe samples: keyframes come
    # from the gap schedule, lost counts only move on fresh samples.
    class _FixedRng:
        def integers(self, lo, hi):
            return 10

    n = 40
    frames, (Rs, ts) = _render(corridor, n)
    vo = _make_vo(_FixedRng(), max_delay=10)
    for il, ir in frames:
        vo.process(il, ir)
    kf_frames = [i for i, r in enumerate(vo.results) if r.is_keyframe]
    gaps = np.diff(kf_frames)
    assert gaps.max() <= vo.cfg.kf_max_gap
    # No forced recovery should ever have fired on this clean sequence.
    assert getattr(vo, "_lost_count", 0) == 0
    vo.close()


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_hard_lag_is_backend_independent(corridor, monkeypatch, backend):
    # Samples that never land on their own are force-joined at exactly
    # the default hard lag, max(2, stats_max_lag), whatever backend the
    # process reports.
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: backend)

    class _NeverLands:
        def integers(self, lo, hi):
            return 10**6

    frames, _ = _render(corridor, 16)
    vo = _make_vo(_NeverLands(), max_delay=0)
    ages = []
    inner = vo._stats_reader

    class _Recording:
        def submit(self, fn, *args):
            fut = inner.submit(fn, *args)
            frame = vo.frame_idx
            result = fut.result

            def timed_result():
                ages.append(vo.frame_idx - frame)
                return result()

            fut.result = timed_result
            return fut

        def shutdown(self, **kw):
            inner.shutdown(**kw)

    vo._stats_reader = _Recording()
    for il, ir in frames:
        vo.process(il, ir)
    vo.close()
    assert ages, "no stats sample was consumed"
    assert set(ages) == {max(2, vo.cfg.stats_max_lag)}, ages
