"""Sliding-window bundle adjustment: Levenberg–Marquardt with Schur complement.

The reference *declares* this capability — ``Backend::run()`` "performs
optimizations" on the shared map (``include/slam/backend/backend.hpp:10-18``)
— but ships no implementation.  This module provides it the accelerator way
(SURVEY §7 step 7, BASELINE north star): batched dense linear algebra.

Structure per LM iteration (all shapes static, everything one jitted graph):

  * residuals  r_ij = π(K(R_i X_j + t_i)) − uv_ij   over the dense (W, P)
    observation grid, Huber-weighted;
  * Jacobian blocks A_ij (2×6, pose) and B_ij (2×3, point) via ``jax.jacfwd``
    of the per-observation residual, ``vmap``-ed over the grid;
  * Hessian blocks U_i = Σ_j AᵀA, V_j = Σ_i BᵀB, W_ij = AᵀB as einsums;
  * Schur complement S = U − Σ_j W V⁻¹ Wᵀ — a dense (6W, 6W) system (tiny:
    48×48 for an 8-frame window) solved directly, then point back-substitution
    with batched 3×3 solves;
  * gauge: pose 0 is frozen (monocular gauge freedom), and LM damping
    adapts by accept/reject via ``jnp.where`` — no data-dependent control
    flow.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpuslam.backend.map import MapState
from tpuslam.common.geometry import so3_exp


class BAResult(NamedTuple):
    map: MapState
    initial_cost: jax.Array
    final_cost: jax.Array
    iterations: jax.Array


def _project_residual(R, t, X, uv, K):
    """(2,) reprojection residual for one observation."""
    cam = R @ X + t
    z = jnp.maximum(cam[2], 1e-6)
    pix = K @ (cam / z)
    return pix[:2] - uv


def _residual_with_delta(delta_pose, delta_point, R, t, X, uv, K):
    """Residual after applying local updates (the BA parameterisation).

    delta_pose ∈ se(3) as (ω, ν): R ← exp(ω)·R, t ← exp(ω)·t + ν.
    """
    dR = so3_exp(delta_pose[:3])
    R_new = dR @ R
    t_new = dR @ t + delta_pose[3:]
    return _project_residual(R_new, t_new, X + delta_point, uv, K)


def _huber_weight(r_norm: jax.Array, delta: float) -> jax.Array:
    """IRLS weight for the Huber kernel."""
    return jnp.where(r_norm <= delta, 1.0, delta / jnp.maximum(r_norm, 1e-12))


def _inv3x3(A: jax.Array) -> jax.Array:
    """Closed-form inverse of (..., 3, 3) matrices (adjugate / determinant).

    Elementwise arithmetic only — XLA fuses the whole thing, unlike
    ``jnp.linalg.inv`` whose batched LU factorisation is a long sequential
    chain of small kernels.  Callers guarantee invertibility (LM-damped blocks).
    """
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    adj = jnp.stack(
        [
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c10, c11, c12], axis=-1),
            jnp.stack([c20, c21, c22], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def _cost(R, t, points, obs_uv, obs_mask, K, huber: float) -> jax.Array:
    res = jax.vmap(
        jax.vmap(_project_residual, in_axes=(None, None, 0, 0, None)),
        in_axes=(0, 0, None, 0, None),
    )(R, t, points, obs_uv, K)  # (W, P, 2)
    rn = jnp.linalg.norm(res, axis=-1)
    # Huber cost
    c = jnp.where(rn <= huber, 0.5 * rn**2, huber * (rn - 0.5 * huber))
    return jnp.sum(jnp.where(obs_mask, c, 0.0))


@partial(
    jax.jit,
    static_argnames=("iterations", "fix_first_pose", "active_points", "rtol"),
)
def bundle_adjust(
    m: MapState,
    K: jax.Array,
    *,
    iterations: int = 10,
    huber_px: float = 2.0,
    init_lambda: float = 1e-3,
    fix_first_pose: bool = True,
    active_points: int | None = 1024,
    rtol: float = 0.0,
) -> BAResult:
    """Optimise keyframe poses and points in place (functional).

    ``active_points``: compact the optimisation to this many *observed*
    points.  The dense (W, P-capacity) observation grid is the right layout
    for accumulating observations, but the LM loop's Hessian einsums scale
    linearly in P — at 4096-slot capacity with only a few hundred observed
    points, >75% of every einsum was dead work (the round-2 SLAM-mode
    bottleneck).  Observed slots are gathered into a dense block once before
    the loop and scattered back once after; any observed points beyond the
    budget keep their values (they simply aren't optimised this window).
    ``None`` disables compaction.

    ``rtol``: adaptive LM termination.  0 (default) runs exactly
    ``iterations`` LM steps (a ``lax.scan`` — fully static, required where
    bit-reproducible step counts matter, e.g. the full-vs-compact
    cross-check in ``test_ba.py``).  >0 switches to a ``lax.while_loop``
    that stops early once an *accepted* step improves the cost by less
    than ``rtol`` relative, or λ hits its ceiling (hopeless); rejected
    steps keep looping so LM can recover by raising λ.  On the fixtures
    the cost plateaus after 4–5 of the 8 budgeted steps, so this trims
    ~40% of BA's per-window cost without touching the optimum.
    """
    Kf = K.astype(jnp.float32)
    W = m.window
    huber = jnp.float32(huber_px)

    full_mask = m.obs_mask & m.kf_valid[:, None] & m.point_valid[None, :]
    _ba_input = m

    if active_points is not None and active_points < m.capacity:
        seen_full = jnp.any(full_mask, axis=0)  # (P,)
        # Indices of (up to) active_points observed slots; top_k on the
        # 0/1 mask is stable, so real slots come first in ascending order.
        _, act_idx = jax.lax.top_k(seen_full.astype(jnp.int32), active_points)
        act_valid = seen_full[act_idx]
        points_full = m.points
        m = m._replace(
            points=m.points[act_idx],
            point_valid=m.point_valid[act_idx] & act_valid,
            point_birth=m.point_birth[act_idx],
            obs_uv=jnp.take(m.obs_uv, act_idx, axis=1),
            obs_mask=jnp.take(m.obs_mask, act_idx, axis=1) & act_valid[None, :],
        )
        mask = full_mask[:, act_idx] & act_valid[None, :]
    else:
        act_idx = None
        mask = full_mask
    P = m.capacity

    def blocks(R, t, X, uv):
        """Closed-form Jacobian blocks of the residual at delta = 0.

        Equivalent to ``jacfwd(_residual_with_delta)`` (cross-checked in
        ``test_ba.py``) but ~5× cheaper: the forward-mode version pushes 9
        tangents through the projection per observation; the closed form is
        the textbook chain rule — ∂π/∂cam = [[fx/z, 0, −fx·x/z²],
        [0, fy/z, −fy·y/z²]], ∂cam/∂ω = −[cam]ₓ (left-multiplied exp(ω)),
        ∂cam/∂ν = I, ∂cam/∂X = R.
        """
        from tpuslam.common.geometry import hat

        cam = R @ X + t
        z = jnp.maximum(cam[2], 1e-6)
        inv_z = 1.0 / z
        fx, fy = Kf[0, 0], Kf[1, 1]
        j_pi = jnp.stack(
            [
                jnp.stack([fx * inv_z, jnp.zeros(()), -fx * cam[0] * inv_z * inv_z]),
                jnp.stack([jnp.zeros(()), fy * inv_z, -fy * cam[1] * inv_z * inv_z]),
            ]
        )  # (2, 3)
        Ja = jnp.concatenate([-(j_pi @ hat(cam)), j_pi], axis=1)  # (2, 6)
        Jb = j_pi @ R  # (2, 3)
        r = _project_residual(R, t, X, uv, Kf)
        return Ja, Jb, r  # (2,6), (2,3), (2,)

    blocks_grid = jax.vmap(
        jax.vmap(blocks, in_axes=(None, None, 0, 0)), in_axes=(0, 0, None, 0)
    )

    # Monocular scale gauge: freezing one pose leaves a global-similarity
    # null direction (scale the world about the frozen pose's centre and
    # every reprojection is unchanged), along which LM drifts freely.  Each
    # candidate is renormalised so the baseline between the two oldest
    # keyframes keeps its input length — a pure gauge transform, so the
    # cost is untouched.
    big = jnp.iinfo(jnp.int32).max
    order = jnp.argsort(jnp.where(m.kf_valid, m.kf_id, big))
    g0, g1 = order[0], order[1]

    # Freeze the OLDEST valid keyframe (gauge) by masking its updates — the
    # same keyframe the scale renorm is centred on.  Anchoring both to g0
    # (rather than ring slot 0) keeps the frozen pose genuinely fixed once
    # the window wraps and slot 0 no longer holds the oldest keyframe.
    pose_free = jnp.ones((W,), jnp.float32)
    if fix_first_pose:
        pose_free = jnp.where(jnp.arange(W) == g0, 0.0, 1.0)

    def centers(R, t):
        return -jnp.einsum("wji,wj->wi", R, t, precision="highest")

    def baseline(R, t):
        C = centers(R, t)
        return jnp.linalg.norm(C[g1] - C[g0])

    b0 = baseline(m.kf_R, m.kf_t)
    gauge_ok = (
        jnp.sum(m.kf_valid.astype(jnp.int32)) >= 2
    ) & (b0 > 1e-6) & bool(fix_first_pose)

    seen_pts = jnp.any(mask, axis=0)  # (P,) — points the LM step moves

    def renorm_scale(R, t, X):
        s = jnp.where(gauge_ok, b0 / jnp.maximum(baseline(R, t), 1e-9), 1.0)
        C = centers(R, t)
        C0 = C[g0]
        C_new = C0 + s * (C - C0)
        t_new = -jnp.einsum("wij,wj->wi", R, C_new, precision="highest")
        # The gauge transform applies to exactly the points the LM delta
        # moved (observed ones): the renorm restores the window to its
        # INPUT scale b0 every accepted step, so untouched points are
        # already consistent — rescaling them too would shrink them by the
        # step's drift factor while the window stays put (the round-2
        # "rescale every valid point" change did precisely that; under
        # active-point compaction the two paths also diverged because the
        # compacted block only contains observed slots).
        X_new = jnp.where(seen_pts[:, None], C0 + s * (X - C0), X)
        return t_new, X_new

    def lm_step(carry, _):
        R, t, X, lam, cost = carry
        A, B, r = blocks_grid(R, t, X, m.obs_uv)  # (W,P,2,6), (W,P,2,3), (W,P,2)
        rn = jnp.linalg.norm(r, axis=-1)
        w = jnp.where(mask, _huber_weight(rn, huber), 0.0)  # (W, P)

        # One combined Jacobian block J = [A | B] (W, P, 2, 9) turns the five
        # separate Hessian/gradient einsums into TWO contractions plus free
        # (fused) slices and sums — the LM loop is op-count-bound
        # (every extra dot is a separate kernel × LM iterations), not
        # FLOP-bound at these shapes.
        J = jnp.concatenate([A, B], axis=-1)  # (W, P, 2, 9)
        Jw = J * w[..., None, None]
        H9 = jnp.einsum("wpri,wprj->wpij", Jw, J, precision="highest")  # (W,P,9,9)
        g9 = -jnp.einsum("wpri,wpr->wpi", Jw, r, precision="highest")  # (W, P, 9)
        U = jnp.sum(H9[..., :6, :6], axis=1)  # (W, 6, 6)
        V = jnp.sum(H9[..., 6:, 6:], axis=0)  # (P, 3, 3)
        Wb = H9[..., :6, 6:]  # (W, P, 6, 3)
        ga = jnp.sum(g9[..., :6], axis=1)  # (W, 6)
        gb = jnp.sum(g9[..., 6:], axis=0)  # (P, 3)

        eye6 = jnp.eye(6, dtype=jnp.float32)
        eye3 = jnp.eye(3, dtype=jnp.float32)
        U_d = U + lam * eye6[None]
        V_d = V + lam * eye3[None] + 1e-8 * eye3[None]
        # Closed-form adjugate inverse of the symmetric 3×3 blocks: pure
        # elementwise arithmetic XLA fuses into one kernel, where
        # ``jnp.linalg.inv`` lowers to a batched LU (a serial chain of small steps).
        # Inactive points have V = λI → harmless.
        V_inv = _inv3x3(V_d)  # (P, 3, 3)

        # Schur complement over poses: S (W, 6, W, 6)
        WVinv = jnp.einsum("wpij,pjk->wpik", Wb, V_inv, precision="highest")  # (W, P, 6, 3)
        S_off = jnp.einsum("wpik,vpjk->wivj", WVinv, Wb, precision="highest")  # (W, 6, W, 6)
        S = -S_off
        S = S.at[jnp.arange(W), :, jnp.arange(W), :].add(U_d)
        rhs = ga - jnp.einsum("wpik,pk->wi", WVinv, gb, precision="highest")  # (W, 6)

        # Gauge fixing: zero rows/cols of frozen poses, identity diagonal.
        free = pose_free[:, None]  # (W, 1)
        S = S * free[:, :, None, None] * free[None, None, :, :]
        S = S.at[jnp.arange(W), :, jnp.arange(W), :].add(
            (1.0 - pose_free)[:, None, None] * eye6[None]
        )
        rhs = rhs * free

        Sd = S.reshape(6 * W, 6 * W)
        delta_a = jnp.linalg.solve(
            Sd + 1e-8 * jnp.eye(6 * W), rhs.reshape(-1)
        ).reshape(W, 6)
        delta_a = delta_a * free
        delta_b = jnp.einsum(
            "pij,pj->pi", V_inv,
            gb - jnp.einsum("wpij,wi->pj", Wb, delta_a, precision="highest"),
            precision="highest",
        )
        # Only move observed points.
        seen = jnp.any(mask, axis=0)
        delta_b = jnp.where(seen[:, None], delta_b, 0.0)

        # Candidate update (+ scale-gauge renormalisation, cost-invariant).
        dRs = so3_exp(delta_a[:, :3])
        R_new = dRs @ R
        t_new = jnp.einsum("wij,wj->wi", dRs, t, precision="highest") + delta_a[:, 3:]
        X_new = X + delta_b
        t_new, X_new = renorm_scale(R_new, t_new, X_new)
        new_cost = _cost(R_new, t_new, X_new, m.obs_uv, mask, Kf, huber)

        accept = new_cost < cost
        R = jnp.where(accept, R_new, R)
        t = jnp.where(accept, t_new, t)
        X = jnp.where(accept, X_new, X)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-9), jnp.minimum(lam * 4.0, 1e6))
        return (R, t, X, lam, cost), cost

    init_cost = _cost(m.kf_R, m.kf_t, m.points, m.obs_uv, mask, Kf, huber)
    carry = (m.kf_R, m.kf_t, m.points, jnp.float32(init_lambda), init_cost)
    if rtol > 0.0:

        def not_done(st):
            i, _, done = st
            return (i < iterations) & ~done

        def body(st):
            i, c, _ = st
            prev_cost = c[4]
            c2, _ = lm_step(c, None)
            new_cost, new_lam = c2[4], c2[3]
            accept = new_cost < prev_cost
            rel = (prev_cost - new_cost) / jnp.maximum(prev_cost, 1e-12)
            done = (accept & (rel < rtol)) | (new_lam >= 1e6)
            return (i + 1, c2, done)

        n_iter, carry, _ = jax.lax.while_loop(
            not_done,
            body,
            (jnp.asarray(0, jnp.int32), carry, jnp.asarray(False)),
        )
    else:
        carry, _ = jax.lax.scan(lm_step, carry, None, length=iterations)
        n_iter = jnp.asarray(iterations, jnp.int32)
    R, t, X, _, final_cost = carry

    if act_idx is not None:
        # Scatter the optimised block back into the full point buffer
        # (dense-table scatter; see map.scatter_rows_dense).
        from tpuslam.backend.map import _apply_row_scatter

        points_out = _apply_row_scatter(points_full, X, act_idx, act_valid)
        out_map = _ba_input._replace(kf_R=R, kf_t=t, points=points_out)
    else:
        out_map = m._replace(kf_R=R, kf_t=t, points=X)

    return BAResult(
        map=out_map,
        initial_cost=init_cost,
        final_cost=final_cost,
        iterations=n_iter,
    )
