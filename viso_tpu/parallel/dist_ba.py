"""Distributed bundle adjustment: landmarks sharded over a device mesh.

No reference counterpart exists (the reference is single-threaded CPU,
SURVEY.md §2 "Parallelism: NONE"); this implements the north-star
distributed BA design: keyframe (camera) blocks replicated, landmark
blocks and their Schur marginalization shard-local, and only the reduced
camera system — (6C)^2 + 6C floats per LM iteration — crossing the
interconnect via `psum`.

Communication analysis: for C = 16 window cameras the reduced system is
~37 KB/iteration regardless of landmark count, so scaling efficiency is
bounded by compute balance, not bandwidth — the landmark dimension is
padded to a multiple of the mesh size and split evenly.
`psum_bytes_per_iter` makes this analysis a first-class, benchmarkable
quantity.
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from viso_tpu.backend import ba
from viso_tpu.parallel.mesh import LANDMARK_AXIS


def pad_landmarks(prob: ba.BAProblem, multiple: int) -> ba.BAProblem:
    """Pad the landmark axis so it splits evenly across the mesh."""
    L = prob.points.shape[0]
    pad = (-L) % multiple
    if pad == 0:
        return prob
    return prob._replace(
        points=jnp.pad(prob.points, ((0, pad), (0, 0))),
        obs_uv=jnp.pad(prob.obs_uv, ((0, 0), (0, pad), (0, 0))),
        obs_mask=jnp.pad(prob.obs_mask, ((0, 0), (0, pad))),
        point_mask=jnp.pad(prob.point_mask, ((0, pad),)),
    )


def psum_bytes_per_iter(num_cams: int, dtype_bytes: int = 4) -> int:
    """Bytes each LM iteration all-reduces over the mesh.

    TWO collectives per iteration (r5; was four in r1-r4):
      1. ONE fused psum inside schur_solve carrying U (C,6,6), g_c
         (C,6), the Schur cross terms S_cross (C,C,6,6) / b_cross
         (C,6), and the folded current-state cost scalar.
      2. The accept-test compute_cost psum (cost + n_obs scalars).
    Independent of the landmark count — the whole point of the
    landmark-sharded layout.
    """
    C = num_cams
    per_iter = (
        C * 36        # U
        + C * 6       # g_c
        + C * C * 36  # S_cross
        + C * 6       # b_cross
        + 1           # folded current-state cost
        + 2           # accept-test compute_cost: cost + n_obs
    )
    return per_iter * dtype_bytes


@functools.lru_cache(maxsize=32)
def make_sharded_solver(mesh: Mesh, params: ba.BAParams):
    """A reusable jitted landmark-sharded BA solver over `mesh`.

    Cached per (mesh, params): engine loops call this every keyframe and
    must reuse one executable (re-wrapping shard_map per call would
    re-trace and re-compile; jit's own cache then keys on shapes).

    The returned fn takes a BAProblem whose landmark axis is already a
    multiple of the mesh size (see pad_landmarks) and returns
    (BAProblem, info) like ba.solve.
    """
    lm_specs = ba.BAProblem(
        R=P(), t=P(), points=P(LANDMARK_AXIS),
        obs_uv=P(None, LANDMARK_AXIS), obs_mask=P(None, LANDMARK_AXIS),
        cam_mask=P(), point_mask=P(LANDMARK_AXIS),
        cam_fixed=P(),
    )
    out_specs = (
        lm_specs,
        {
            "initial_cost": P(),
            "final_cost": P(),
            "cost_history": P(),
            "num_obs": P(),
            "final_lambda": P(),
        },
    )

    @partial(
        shard_map, mesh=mesh, in_specs=(lm_specs,), out_specs=out_specs,
        check_vma=False,
    )
    def _run(p):
        return ba.solve_impl(p, params, axis_name=LANDMARK_AXIS)

    def run(prob: ba.BAProblem):
        # shard_map specs cover every leaf, including cam_fixed — give a
        # problem without an explicit gauge mask an all-False one.
        if prob.cam_fixed is None:
            prob = prob._replace(
                cam_fixed=jnp.zeros(prob.R.shape[0], bool)
            )
        return _run(prob)

    return jax.jit(run)


def solve_sharded(
    prob: ba.BAProblem,
    params: ba.BAParams = ba.BAParams(),
    mesh: Mesh | None = None,
):
    """Distributed ba.solve over `mesh` (defaults to all devices).

    Returns (BAProblem, info) like ba.solve; the input problem may have
    any landmark count (padded internally). The underlying sharded
    executable is cached per (mesh, params) — repeat calls with equal
    shapes hit the jit cache.
    """
    from viso_tpu.parallel.mesh import make_mesh

    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    prob_p = pad_landmarks(prob, n_dev)

    out, info = make_sharded_solver(mesh, params)(prob_p)
    # Strip padding.
    L0 = prob.points.shape[0]
    out = out._replace(
        points=out.points[:L0],
        obs_uv=out.obs_uv[:, :L0],
        obs_mask=out.obs_mask[:, :L0],
        point_mask=out.point_mask[:L0],
    )
    return out, info
