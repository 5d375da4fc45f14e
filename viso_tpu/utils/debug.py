"""Numeric-sanitizer analogue for the jitted pipeline (SURVEY.md §5).

The reference has no sanitizers (single-threaded C++, bare -O2,
CMakeLists.txt:3); its runtime checks are scattered NaN bailouts
(viso.cpp:315, 741, 896). The equivalents here:

  * NaN debugging: `enable_nan_checks()` flips JAX's debug-NaN mode —
    every jitted kernel re-runs op-by-op when its output contains NaN
    and raises AT THE PRODUCING OP (the production kernels instead
    carry branchless `isfinite` guards, e.g. ops/direct.py and
    backend/ba.py, which SUPPRESS NaNs — right for production, wrong
    for debugging them). Also via env: VISO_DEBUG_NANS=1.
  * State audits: `check_finite_state(engine)` sweeps every array of
    the live engine state (map, pose, pose graph, loop DB) and reports
    which field went non-finite — the map is all fixed-capacity masked
    arrays, so one sweep covers the whole SLAM state.

Buffer-donation audit: the engine deliberately donates NOTHING — every
per-frame kernel treats the map as immutable and returns a new one
(keyframe snapshots, the async loop-layer digest, and the bench's
silicon probes all read old map references after the kernels that
produced their successors ran). `assert_no_donation()` pins that
invariant so a future "optimization" cannot silently invalidate those
readers.
"""

from __future__ import annotations

import os

import numpy as np

import jax


def enable_nan_checks(enabled: bool = True):
    """Globally enable JAX debug-NaN mode (expensive: per-op re-runs on
    NaN detection; use for debugging only)."""
    jax.config.update("jax_debug_nans", enabled)


if os.environ.get("VISO_DEBUG_NANS") == "1":
    enable_nan_checks(True)


def check_finite_state(engine) -> list[str]:
    """Audit every array of a VO/SLAM engine for non-finite values.

    Returns the list of offending field names (empty = healthy).
    Pulls the full state host-side: a debugging/checkpoint-time tool,
    not a per-frame check.
    """
    bad: list[str] = []

    def scan(name, arr):
        try:
            a = np.asarray(arr)
        except Exception:
            return
        if a.dtype.kind == "f" and not np.all(np.isfinite(a)):
            bad.append(name)

    m = engine.map
    for field in m._fields:
        v = getattr(m, field)
        if isinstance(v, tuple):
            for lvl, x in enumerate(v):
                scan(f"map.{field}[{lvl}]", x)
        else:
            scan(f"map.{field}", v)
    scan("R", engine.R)
    scan("t", engine.t)
    for attr in ("pg_raw_R", "pg_raw_t", "pg_R", "pg_t", "pg_s"):
        v = getattr(engine, attr, None)
        if v:
            scan(attr, np.stack(v) if isinstance(v[0], np.ndarray) else v)
    db = getattr(engine, "loop_db", None)
    if db is not None:
        for attr in ("points_w", "R", "t", "path_len", "rot_len"):
            scan(f"loop_db.{attr}", getattr(db, attr))
    return bad


def assert_no_donation():
    """Pin the no-donation invariant of the engine kernels.

    Scans the engine module source for donate_argnums/donate_argnames:
    the async loop layer and bench silicon probes read OLD map
    references after newer maps exist, which donation would invalidate
    (jax raises 'buffer was donated' on access).
    """
    import inspect

    from viso_tpu.slam import engine as engine_mod

    src = inspect.getsource(engine_mod)
    assert "donate_argnums" not in src and "donate_argnames" not in src, (
        "engine kernels must not donate buffers: the loop-layer digest "
        "and bench probes read pre-update map snapshots"
    )
