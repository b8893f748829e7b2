"""Pose-graph optimisation: fold loop-closure constraints into the trajectory.

The reference detects loops (``LoopClosure::detect`` returns a relative
transform, ``loop_closure.hpp:17-20``) but has no machinery to *use* them —
its ``Backend``/``SLAMModel`` were never implemented.  This module closes
that gap the accelerator way: a Gauss–Newton pose-graph solver over SE(3) nodes with
fixed-capacity edge buffers, Jacobians from ``jax.jacfwd`` on the edge
residual, and one dense (6N, 6N) normal-equation solve per iteration —
dense linear algebra is cheap at SLAM-scale node counts and far friendlier
to an accelerator than sparse factorization.

Residual per edge (i → j, measured relative transform T̂_ij, cam-to-world
nodes T_i): r = log(T̂_ij⁻¹ · T_i⁻¹ · T_j) ∈ se(3); gauge fixed at node 0.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpuslam.common.geometry import so3_exp, so3_log


class PoseGraph(NamedTuple):
    """Fixed-capacity pose graph (pytree)."""

    nodes: jax.Array  # (N, 4, 4) — T_world_cam per node
    node_valid: jax.Array  # (N,) bool
    edge_i: jax.Array  # (E,) int32
    edge_j: jax.Array  # (E,) int32
    edge_T: jax.Array  # (E, 4, 4) — measured T_i⁻¹ T_j
    edge_weight: jax.Array  # (E,) float32 (0 = inactive)


def empty_graph(max_nodes: int, max_edges: int) -> PoseGraph:
    return PoseGraph(
        nodes=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (max_nodes, 4, 4)),
        node_valid=jnp.zeros((max_nodes,), bool),
        edge_i=jnp.zeros((max_edges,), jnp.int32),
        edge_j=jnp.zeros((max_edges,), jnp.int32),
        edge_T=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (max_edges, 4, 4)),
        edge_weight=jnp.zeros((max_edges,), jnp.float32),
    )


def _se3_log(T: jax.Array) -> jax.Array:
    """(…, 4, 4) → (…, 6) (ω, ν) — first-order (ν = translation) is enough
    for residuals near identity, which GN drives them to."""
    w = so3_log(T[..., :3, :3])
    return jnp.concatenate([w, T[..., :3, 3]], axis=-1)


def _apply_delta(T: jax.Array, delta: jax.Array) -> jax.Array:
    """Left-multiplicative update: T ← exp(δ)·T."""
    dR = so3_exp(delta[..., :3])
    R = jnp.matmul(dR, T[..., :3, :3], precision="highest")
    t = (
        jnp.einsum("...ij,...j->...i", dR, T[..., :3, 3], precision="highest")
        + delta[..., 3:]
    )
    out = jnp.zeros_like(T)
    out = out.at[..., :3, :3].set(R)
    out = out.at[..., :3, 3].set(t)
    return out.at[..., 3, 3].set(1.0)


def _edge_residual(delta_i, delta_j, Ti, Tj, T_meas_inv):
    Ti_new = _apply_delta(Ti, delta_i)
    Tj_new = _apply_delta(Tj, delta_j)
    # T_rel = Ti⁻¹ Tj  (both cam-to-world)
    Ri = Ti_new[:3, :3]
    rel_R = jnp.matmul(Ri.T, Tj_new[:3, :3], precision="highest")
    rel_t = Ri.T @ (Tj_new[:3, 3] - Ti_new[:3, 3])
    rel = jnp.eye(4, dtype=Ti.dtype)
    rel = rel.at[:3, :3].set(rel_R).at[:3, 3].set(rel_t)
    err = jnp.matmul(T_meas_inv, rel, precision="highest")
    return _se3_log(err)


@partial(jax.jit, static_argnames=("iterations", "solver", "cg_iterations"))
def optimize_pose_graph(
    g: PoseGraph,
    *,
    iterations: int = 10,
    damping: float = 1e-6,
    solver: str | None = None,
    cg_iterations: int | None = None,
) -> PoseGraph:
    """Gauss–Newton over all nodes; node 0 is the gauge anchor.

    Two linear solvers behind the same GN loop:

    * ``"dense"`` — materialise H (N,6,N,6) and LU-solve (6N, 6N).  Exact;
      memory is O(36 N²) and the LU workspace asks for 18 GB at N≈1500,
      so it is the default only for N ≤ 256.
    * ``"pcg"`` — matrix-free preconditioned conjugate gradient.  The
      per-edge 6×6 blocks (JᵀWJ) are kept in (E, 6, 6) form and H·v is
      computed edge-wise each CG step: gather v at edge endpoints, apply
      the blocks, and accumulate back through one-hot (N, E) matmuls
      (scatter-add over repeated indices serialises — the same
      reformulation as ``map.scatter_rows_dense``).  Block-Jacobi
      preconditioner from the diagonal blocks.  Memory O(E·36 + N·E),
      compute is dense matmuls — KITTI-scale graphs (thousands of nodes)
      fit.  The reference has no pose-graph
      machinery at all (its LoopResult transforms are dropped); this is
      capability beyond it, sized for its intended domain.
    """
    N = g.nodes.shape[0]
    if solver is None:
        solver = "dense" if N <= 256 else "pcg"
    if cg_iterations is None:
        # CG propagates information one graph hop per iteration; a chain
        # needs ≥N iterations to carry a loop correction end-to-end
        # (measured on the 60-node drift fixture: 100 iters left 0.09
        # position error vs dense, 200 → 5e-4, 400 → exact).  Hv is two
        # (N, E) matmuls — thousands of iterations are cheap,
        # so the budget scales with N (a hard 2000 cap silently under-
        # converged chains longer than 2000 nodes); the while_loop below
        # exits early on the residual test, so oversizing is free.
        cg_iterations = max(4 * N, 200)
    T_meas_inv = jnp.linalg.inv(g.edge_T)

    jac = jax.jacfwd(_edge_residual, argnums=(0, 1))
    zero6 = jnp.zeros(6, jnp.float32)

    free = g.node_valid.astype(jnp.float32).at[0].set(0.0)  # (N,)

    E = g.edge_i.shape[0]
    # One-hot accumulators (fixed per graph): Si[n,e] = [edge_i[e] == n].
    if solver == "pcg":
        narange = jnp.arange(N, dtype=g.edge_i.dtype)
        Si = (g.edge_i[None, :] == narange[:, None]).astype(jnp.float32)
        Sj = (g.edge_j[None, :] == narange[:, None]).astype(jnp.float32)

    def edge_blocks(nodes):
        Ti = nodes[g.edge_i]
        Tj = nodes[g.edge_j]

        def per_edge(Ti_e, Tj_e, Tm_e):
            Ji, Jj = jac(zero6, zero6, Ti_e, Tj_e, Tm_e)
            r = _edge_residual(zero6, zero6, Ti_e, Tj_e, Tm_e)
            return Ji, Jj, r

        return jax.vmap(per_edge)(Ti, Tj, T_meas_inv)  # (E,6,6),(E,6,6),(E,6)

    def gn_step_dense(nodes, _):
        Ji, Jj, r = edge_blocks(nodes)
        w = g.edge_weight  # (E,)

        H = jnp.zeros((N, 6, N, 6), jnp.float32)
        b = jnp.zeros((N, 6), jnp.float32)

        def blocks(Ja, Jb):
            return jnp.einsum("eri,e,erj->eij", Ja, w, Jb, precision="highest")

        H = H.at[g.edge_i, :, g.edge_i, :].add(blocks(Ji, Ji))
        H = H.at[g.edge_j, :, g.edge_j, :].add(blocks(Jj, Jj))
        H = H.at[g.edge_i, :, g.edge_j, :].add(blocks(Ji, Jj))
        H = H.at[g.edge_j, :, g.edge_i, :].add(blocks(Jj, Ji))
        b = b.at[g.edge_i].add(-jnp.einsum("eri,e,er->ei", Ji, w, r, precision="highest"))
        b = b.at[g.edge_j].add(-jnp.einsum("eri,e,er->ei", Jj, w, r, precision="highest"))

        # Gauge + inactive nodes: zero their rows/cols, identity diagonal.
        H = H * free[:, None, None, None] * free[None, None, :, None]
        H = H.at[jnp.arange(N), :, jnp.arange(N), :].add(
            ((1.0 - free) + damping)[:, None, None] * jnp.eye(6)[None]
        )
        b = b * free[:, None]

        delta = jnp.linalg.solve(H.reshape(6 * N, 6 * N), b.reshape(-1)).reshape(N, 6)
        delta = delta * free[:, None]
        return jax.vmap(_apply_delta)(nodes, delta), None

    def gn_step_pcg(nodes, _):
        Ji, Jj, r = edge_blocks(nodes)
        w = g.edge_weight

        def blocks(Ja, Jb):
            return jnp.einsum("eri,e,erj->eij", Ja, w, Jb, precision="highest")

        Aii, Ajj, Aij = blocks(Ji, Ji), blocks(Jj, Jj), blocks(Ji, Jj)
        bi = -jnp.einsum("eri,e,er->ei", Ji, w, r, precision="highest")
        bj = -jnp.einsum("eri,e,er->ei", Jj, w, r, precision="highest")
        b = (Si @ bi + Sj @ bj) * free[:, None]  # (N, 6)

        def hv(v):
            """H·v with the dense path's gauge/damping semantics."""
            ve = v * free[:, None]
            vi = ve[g.edge_i]
            vj = ve[g.edge_j]
            yi = jnp.einsum("eij,ej->ei", Aii, vi) + jnp.einsum(
                "eij,ej->ei", Aij, vj
            )
            yj = jnp.einsum("eji,ej->ei", Aij, vi) + jnp.einsum(
                "eij,ej->ei", Ajj, vj
            )
            y = (Si @ yi + Sj @ yj) * free[:, None]
            return y + ((1.0 - free) + damping)[:, None] * v

        # Block-Jacobi preconditioner: the diagonal blocks of H.
        D = (
            (Si @ Aii.reshape(E, 36) + Sj @ Ajj.reshape(E, 36)).reshape(N, 6, 6)
            * free[:, None, None]
            + ((1.0 - free) + damping)[:, None, None] * jnp.eye(6)[None]
        )
        Dinv = jnp.linalg.inv(D)  # (N, 6, 6)

        def precond(v):
            return jnp.einsum("nij,nj->ni", Dinv, v)

        x0 = jnp.zeros_like(b)
        z0 = precond(b)
        rz0 = jnp.vdot(b, z0)
        # Converged = preconditioned residual down 1e-10 relative (rz is
        # a squared norm → 1e-5 on the residual itself, far below the
        # GN re-linearization error the outer loop absorbs).  This is
        # called host-side (never inside a sequence scan), so the
        # while_loop early exit is real wall-clock, not the in-scan
        # control-flow pathology (see SlamSystem._ba_cond).
        tol = 1e-10 * jnp.maximum(rz0, 1e-30)

        def cg_cond(carry):
            _, _, _, rz, it = carry
            return (it < cg_iterations) & (rz > tol)

        def cg_body(carry):
            x, rres, p, rz, it = carry
            Hp = hv(p)
            alpha = rz / jnp.maximum(jnp.vdot(p, Hp), 1e-20)
            x = x + alpha * p
            rres = rres - alpha * Hp
            z = precond(rres)
            rz_new = jnp.vdot(rres, z)
            p = z + (rz_new / jnp.maximum(rz, 1e-20)) * p
            return (x, rres, p, rz_new, it + 1)

        delta, _, _, _, _ = jax.lax.while_loop(
            cg_cond, cg_body, (x0, b, z0, rz0, jnp.int32(0))
        )
        delta = delta * free[:, None]
        delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
        return jax.vmap(_apply_delta)(nodes, delta), None

    step = gn_step_dense if solver == "dense" else gn_step_pcg
    nodes, _ = jax.lax.scan(step, g.nodes, None, length=iterations)
    return g._replace(nodes=nodes)


def add_edge(
    g: PoseGraph, slot: int | jax.Array, i, j, T_rel, weight: float = 1.0
) -> PoseGraph:
    return g._replace(
        edge_i=g.edge_i.at[slot].set(jnp.asarray(i, jnp.int32)),
        edge_j=g.edge_j.at[slot].set(jnp.asarray(j, jnp.int32)),
        edge_T=g.edge_T.at[slot].set(T_rel.astype(jnp.float32)),
        edge_weight=g.edge_weight.at[slot].set(weight),
    )


def graph_from_trajectory(
    poses: jax.Array, max_edges: int | None = None
) -> PoseGraph:
    """Build a chain graph from (N, 4, 4) cam-to-world poses."""
    N = poses.shape[0]
    E = max_edges if max_edges is not None else 4 * N
    g = empty_graph(N, E)
    g = g._replace(
        nodes=poses.astype(jnp.float32),
        node_valid=jnp.ones((N,), bool),
    )
    rel = jnp.einsum(
        "nij,njk->nik", jnp.linalg.inv(poses[:-1]), poses[1:], precision="highest"
    )
    idx = jnp.arange(N - 1)
    g = g._replace(
        edge_i=g.edge_i.at[: N - 1].set(idx.astype(jnp.int32)),
        edge_j=g.edge_j.at[: N - 1].set((idx + 1).astype(jnp.int32)),
        edge_T=g.edge_T.at[: N - 1].set(rel.astype(jnp.float32)),
        edge_weight=g.edge_weight.at[: N - 1].set(1.0),
    )
    return g
