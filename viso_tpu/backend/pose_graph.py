"""Pose-graph optimization over SE(3) (loop-closure backend).

The reference has no pose graph (its backend never ran at all,
`/root/reference/include/bundle_adjuster.h` — see SURVEY.md §2 #18); the
north star (BASELINE.json configs 3-4) requires one for loop closure.
This is the same LM machinery as backend/ba.py restricted to SE3-only
variables: residual of edge (i, j) with measured relative transform
T_ij is  r = log(T_ij^-1 * T_i * T_j^-1)  in the se(3) tangent space.

Edges are fixed-capacity masked arrays; per-edge 6x(12)
Jacobians come from vmapped forward-mode autodiff of the residual (exact,
no hand-derived adjoint bookkeeping to get wrong), scatter-added into the
dense (6K x 6K) system — K is at most a few hundred keyframes, so the
dense solve is cheap.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from viso_tpu.backend import robust
from viso_tpu.geometry import se3


class PoseGraph(NamedTuple):
    R: jnp.ndarray         # (K, 3, 3) world->cam
    t: jnp.ndarray         # (K, 3)
    node_mask: jnp.ndarray  # (K,)
    edge_i: jnp.ndarray    # (E,) int32
    edge_j: jnp.ndarray    # (E,) int32
    R_ij: jnp.ndarray      # (E, 3, 3) measured T_i * T_j^-1
    t_ij: jnp.ndarray      # (E, 3)
    edge_weight: jnp.ndarray  # (E,) scalar information weight
    edge_mask: jnp.ndarray    # (E,)


class PGParams(NamedTuple):
    iters: int = 20
    huber: float = 0.5
    lam0: float = 1e-4
    lam_up: float = 4.0
    lam_down: float = 0.5
    num_fixed: int = 1
    # Linear solver: "dense" materializes the (6K x 6K) system (exact,
    # fine to a few hundred nodes), "pcg" is matrix-free block-Jacobi-
    # preconditioned conjugate gradients on the edge list (O(E) memory —
    # the dense H is ~151 MB at K=1024 and ~2.4 GB at 4096), "auto"
    # switches to pcg above pcg_threshold nodes.
    solver: str = "auto"
    pcg_threshold: int = 320
    pcg_iters: int = 96


def edge_residual(Ri, ti, Rj, tj, R_ij, t_ij):
    """r = log(T_ij^-1 * T_i * T_j^-1) (6,)."""
    R_rel, t_rel = se3.relative(Ri, ti, Rj, tj)
    R_err, t_err = se3.compose(*se3.inverse(R_ij, t_ij), R_rel, t_rel)
    return se3.se3_log(R_err, t_err)


def _edge_residual_perturbed(xi2, Ri, ti, Rj, tj, R_ij, t_ij):
    """Residual with left-perturbations applied to both endpoint poses."""
    Ri_p, ti_p = se3.left_update(xi2[:6], Ri, ti)
    Rj_p, tj_p = se3.left_update(xi2[6:], Rj, tj)
    return edge_residual(Ri_p, ti_p, Rj_p, tj_p, R_ij, t_ij)


def residuals(graph: PoseGraph):
    """All edge residuals (E, 6), zeroed where masked."""
    Ri, ti = graph.R[graph.edge_i], graph.t[graph.edge_i]
    Rj, tj = graph.R[graph.edge_j], graph.t[graph.edge_j]
    r = jax.vmap(edge_residual)(Ri, ti, Rj, tj, graph.R_ij, graph.t_ij)
    return jnp.where(graph.edge_mask[:, None], r, 0.0)


def compute_cost(graph: PoseGraph, params: PGParams = PGParams()):
    r = residuals(graph)
    r_norm = jnp.linalg.norm(r, axis=-1)
    w = graph.edge_weight * graph.edge_mask
    return jnp.sum(w * robust.huber_cost(r_norm, params.huber))


def _gn_step(R, t, graph: PoseGraph, lam, params: PGParams, K):
    r, J, w, f = _edge_system(R, t, graph, params)
    Ji = J[..., :6] * w[:, None, None]   # weighted (E, 6, 6) wrt node i
    Jj = J[..., 6:] * w[:, None, None]

    # Assemble dense block system via scatter-adds.
    H = jnp.zeros((K, K, 6, 6), R.dtype)
    b = jnp.zeros((K, 6), R.dtype)
    ei, ej = graph.edge_i, graph.edge_j
    H = H.at[ei, ei].add(jnp.einsum("eai,eaj->eij", Ji, J[..., :6]))
    H = H.at[ej, ej].add(jnp.einsum("eai,eaj->eij", Jj, J[..., 6:]))
    H = H.at[ei, ej].add(jnp.einsum("eai,eaj->eij", Ji, J[..., 6:]))
    H = H.at[ej, ei].add(jnp.einsum("eai,eaj->eij", Jj, J[..., :6]))
    b = b.at[ei].add(-jnp.einsum("eai,ea->ei", Ji, r))
    b = b.at[ej].add(-jnp.einsum("eai,ea->ei", Jj, r))

    # Damping + gauge freeze.
    eye6 = jnp.eye(6, dtype=R.dtype)
    diag_blocks = H[jnp.arange(K), jnp.arange(K)]
    diag_scale = jnp.einsum("kii->k", diag_blocks) / 6.0 + 1e-6
    H = H.at[jnp.arange(K), jnp.arange(K)].add(
        lam * diag_scale[:, None, None] * eye6
    )
    H = H * f[:, None, None, None] * f[None, :, None, None]
    H = H.at[jnp.arange(K), jnp.arange(K)].add((1.0 - f)[:, None, None] * eye6)
    b = b * f[:, None]

    H_flat = H.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
    delta = jnp.linalg.solve(H_flat, b.reshape(6 * K)).reshape(K, 6)
    delta = jnp.where(jnp.isfinite(delta), delta, 0.0) * f[:, None]
    R_new, t_new = jax.vmap(se3.left_update)(delta, R, t)
    return R_new, t_new


def _edge_system(R, t, graph: PoseGraph, params: PGParams):
    """Shared LM linearization: per-edge Jacobians, residuals, robust
    weights, and the gauge/free mask. Used by both linear solvers."""
    Ri, ti = R[graph.edge_i], t[graph.edge_i]
    Rj, tj = R[graph.edge_j], t[graph.edge_j]

    def res_fn(xi2, Ri, ti, Rj, tj, R_ij, t_ij):
        return _edge_residual_perturbed(xi2, Ri, ti, Rj, tj, R_ij, t_ij)

    zeros = jnp.zeros((graph.edge_i.shape[0], 12), R.dtype)
    r = jax.vmap(res_fn)(zeros, Ri, ti, Rj, tj, graph.R_ij, graph.t_ij)
    J = jax.vmap(jax.jacfwd(res_fn))(
        zeros, Ri, ti, Rj, tj, graph.R_ij, graph.t_ij
    )  # (E, 6, 12)
    r_norm = jnp.linalg.norm(r, axis=-1)
    w = (
        graph.edge_weight
        * graph.edge_mask
        * robust.huber_weight(r_norm, params.huber)
    )
    K = R.shape[0]
    free = graph.node_mask & (jnp.arange(K) >= params.num_fixed)
    return r, J, w, free.astype(R.dtype)


def _gn_step_pcg(R, t, graph: PoseGraph, lam, params: PGParams, K):
    """Matrix-free LM step: block-Jacobi-preconditioned CG on the edge
    list. Never materializes H — each matvec is two gathers, two batched
    6x12 products, and two scatter-adds over the E edges (O(E) compute
    and memory vs the dense path's O(K^2) blocks + (6K)^2 solve)."""
    r, J, w, f = _edge_system(R, t, graph, params)
    Ji = J[..., :6]                    # (E, 6, 6) wrt node i
    Jj = J[..., 6:]
    ei, ej = graph.edge_i, graph.edge_j

    # RHS b = -J^T W r and block-diagonal D_kk = sum J^T W J (scattered).
    Jiw = Ji * w[:, None, None]
    Jjw = Jj * w[:, None, None]
    b = jnp.zeros((K, 6), R.dtype)
    b = b.at[ei].add(-jnp.einsum("eai,ea->ei", Jiw, r))
    b = b.at[ej].add(-jnp.einsum("eai,ea->ei", Jjw, r))
    D = jnp.zeros((K, 6, 6), R.dtype)
    D = D.at[ei].add(jnp.einsum("eai,eaj->eij", Jiw, Ji))
    D = D.at[ej].add(jnp.einsum("eai,eaj->eij", Jjw, Jj))

    # LM damping matches the dense path: lam * mean-diag scale * I.
    eye6 = jnp.eye(6, dtype=R.dtype)
    diag_scale = jnp.einsum("kii->k", D) / 6.0 + 1e-6
    damp = lam * diag_scale
    D_damped = D + damp[:, None, None] * eye6
    # Gauge: fixed nodes get identity rows in H and 0 rhs.
    D_prec = jnp.where(f[:, None, None] > 0, D_damped, eye6)
    M_inv = jnp.linalg.inv(D_prec)
    b = b * f[:, None]

    def hv(v):
        vi, vj = v[ei], v[ej]
        y = (
            jnp.einsum("eab,eb->ea", Ji, vi)
            + jnp.einsum("eab,eb->ea", Jj, vj)
        ) * w[:, None]
        out = jnp.zeros((K, 6), R.dtype)
        out = out.at[ei].add(jnp.einsum("eab,ea->eb", Ji, y))
        out = out.at[ej].add(jnp.einsum("eab,ea->eb", Jj, y))
        out = out + damp[:, None] * v
        return out * f[:, None] + (1.0 - f)[:, None] * v

    def prec(v):
        return jnp.einsum("kij,kj->ki", M_inv, v)

    def dot(a, bb):
        return jnp.sum(a * bb)

    x0 = jnp.zeros_like(b)
    r0 = b  # b - H @ 0
    z0 = prec(r0)
    p0 = z0

    def body(state, _):
        x, rr, z, pdir, rz = state
        Hp = hv(pdir)
        denom = dot(pdir, Hp)
        alpha = jnp.where(denom > 1e-20, rz / denom, 0.0)
        x = x + alpha * pdir
        r_new = rr - alpha * Hp
        z_new = prec(r_new)
        rz_new = dot(r_new, z_new)
        beta = jnp.where(rz > 1e-20, rz_new / rz, 0.0)
        pdir = z_new + beta * pdir
        return (x, r_new, z_new, pdir, rz_new), None

    init = (x0, r0, z0, p0, dot(r0, z0))
    (delta, _, _, _, _), _ = jax.lax.scan(
        body, init, None, length=params.pcg_iters
    )
    delta = jnp.where(jnp.isfinite(delta), delta, 0.0) * f[:, None]
    R_new, t_new = jax.vmap(se3.left_update)(delta, R, t)
    return R_new, t_new


def _bucket(n: int, floor: int = 16) -> int:
    """Smallest power-of-two capacity >= n (>= floor)."""
    b = floor
    while b < n:
        b *= 2
    return b


def solve_padded(pg_R, pg_t, edges, params: PGParams = PGParams()):
    """Solve a growing pose graph with power-of-two shape bucketing.

    `pg_R`/`pg_t`: lists/arrays of world->cam poses; `edges`: list of
    (i, j, R_ij, t_ij, weight). Nodes and edges are padded to the next
    power-of-two capacity with masked slots, so a live SLAM run retraces
    `solve` only O(log K) times over its whole lifetime instead of once
    per loop event (padded dims double ~5 times from 16 to 512).
    Returns (PoseGraph, info) with padded arrays — slice [:len(pg_R)].
    """
    import numpy as np

    K = len(pg_R)
    E = len(edges)
    Kp = _bucket(K)
    Ep = _bucket(E)

    R = np.zeros((Kp, 3, 3), np.float32)
    R[:] = np.eye(3)
    t = np.zeros((Kp, 3), np.float32)
    R[:K] = np.stack(pg_R)
    t[:K] = np.stack(pg_t)
    node_mask = np.zeros(Kp, bool)
    node_mask[:K] = True

    ei = np.zeros(Ep, np.int32)
    ej = np.zeros(Ep, np.int32)
    R_ij = np.zeros((Ep, 3, 3), np.float32)
    R_ij[:] = np.eye(3)
    t_ij = np.zeros((Ep, 3), np.float32)
    w = np.zeros(Ep, np.float32)
    edge_mask = np.zeros(Ep, bool)
    for k, (i, j, Rm, tm, wt) in enumerate(edges):
        ei[k], ej[k] = i, j
        R_ij[k], t_ij[k] = Rm, tm
        w[k] = wt
        edge_mask[k] = True

    g = PoseGraph(
        R=jnp.asarray(R), t=jnp.asarray(t),
        node_mask=jnp.asarray(node_mask),
        edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
        R_ij=jnp.asarray(R_ij), t_ij=jnp.asarray(t_ij),
        edge_weight=jnp.asarray(w), edge_mask=jnp.asarray(edge_mask),
    )
    return solve(g, params)


@partial(jax.jit, static_argnames=("params",))
def solve(graph: PoseGraph, params: PGParams = PGParams()):
    """LM pose-graph optimization; returns (graph, info).

    The linear solver is picked at trace time (K is static): dense
    below params.pcg_threshold nodes, matrix-free PCG above.
    """
    K = graph.R.shape[0]
    use_pcg = params.solver == "pcg" or (
        params.solver == "auto" and K > params.pcg_threshold
    )
    step = _gn_step_pcg if use_pcg else _gn_step

    def body(state, _):
        R, t, lam, cost = state
        R_n, t_n = step(R, t, graph, lam, params, K)
        new_cost = compute_cost(graph._replace(R=R_n, t=t_n), params)
        accept = new_cost < cost
        R = jnp.where(accept, R_n, R)
        t = jnp.where(accept, t_n, t)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(
            accept,
            jnp.maximum(lam * params.lam_down, 1e-9),
            jnp.minimum(lam * params.lam_up, 1e6),
        )
        return (R, t, lam, cost), cost

    cost0 = compute_cost(graph, params)
    init = (graph.R, graph.t, jnp.asarray(params.lam0, graph.R.dtype), cost0)
    (R, t, lam, cost), hist = jax.lax.scan(body, init, None, length=params.iters)
    return graph._replace(R=R, t=t), {
        "initial_cost": cost0,
        "final_cost": cost,
        "cost_history": hist,
    }
