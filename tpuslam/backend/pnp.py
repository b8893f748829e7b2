"""Batched RANSAC DLT-PnP: camera pose from 3D↔2D correspondences.

Reference semantics (``src/backend/loop_closure.cpp:180-274``):

  * RANSAC loop of ``RansacMaxIterations``: sample 6 unique matches, solve a
    2n×12 DLT system for the projection matrix P, orthogonalise the rotation
    block by SVD with det correction, rescale the translation, count inliers
    by reprojection error < threshold with z > 0 cheirality, keep the best;
  * success iff best inlier count ≥ ``MinInliersForPnP``.

Accelerator-first restructuring: all hypotheses are sampled up front and solved as
one batched 12-dim nullspace problem (one-sided Jacobi — float32-stable, no
AᵀA squaring); all H×M reprojection errors are scored in one pass; a final
least-squares refit on the best consensus set sharpens the pose.

Two deliberate deviations from the reference (documented, not copied):
  * ``loop_closure.cpp:258`` maps the DLT solution vector *column-major*
    into P while the system rows are assembled *row-major* — we use the
    consistent row-major mapping;
  * ``loop_closure.cpp:272`` rescales ``t / ‖R_raw‖_F`` which leaves a
    systematic 1/√3 factor; we use ``s = ‖R_raw‖_F / √3`` (the mean
    singular value) so the recovered translation has metric scale.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpuslam.common.geometry import hat, nullvec_jacobi, orthonormalize_rotation, so3_exp


class PnPResult(NamedTuple):
    R: jax.Array  # (3, 3)
    t: jax.Array  # (3,)
    inliers: jax.Array  # (M,) bool
    num_inliers: jax.Array  # () int32
    success: jax.Array  # () bool


def _dlt_rows(points3d: jax.Array, points2d: jax.Array) -> jax.Array:
    """(..., N, 3)+(..., N, 2) → (..., 2N, 12) DLT constraint rows.

    Row pair per point (reference ``loop_closure.cpp:248-253``):
      [X Y Z 1  0 0 0 0  -uX -uY -uZ -u]
      [0 0 0 0  X Y Z 1  -vX -vY -vZ -v]
    with p = row-major vec(P).
    """
    X = points3d
    ones = jnp.ones((*X.shape[:-1], 1), X.dtype)
    Xh = jnp.concatenate([X, ones], axis=-1)  # (..., N, 4)
    u = points2d[..., 0:1]
    v = points2d[..., 1:2]
    zero = jnp.zeros_like(Xh)
    row_u = jnp.concatenate([Xh, zero, -u * Xh], axis=-1)  # (..., N, 12)
    row_v = jnp.concatenate([zero, Xh, -v * Xh], axis=-1)
    rows = jnp.stack([row_u, row_v], axis=-2)  # (..., N, 2, 12)
    return rows.reshape(*rows.shape[:-3], -1, 12)


def solve_pnp_dlt(
    points3d: jax.Array,
    points2d: jax.Array,
    weights: jax.Array | None = None,
    sweeps: int = 8,
) -> tuple[jax.Array, jax.Array]:
    """Weighted least-squares DLT PnP → (R (..., 3, 3), t (..., 3)).

    ``points2d`` must be in *pixel* coordinates of a calibrated system where
    P = K[R|t] — the caller premultiplies by K⁻¹ (i.e. passes normalised
    coordinates) to recover [R|t] directly, matching the reference which
    solves for P from raw pixels but verifies with K applied separately.
    """
    rows = _dlt_rows(points3d, points2d)  # (..., 2N, 12)
    if weights is not None:
        w2 = jnp.repeat(weights, 2, axis=-1)  # each point contributes 2 rows
        rows = rows * w2[..., None]
    norm = jnp.maximum(jnp.linalg.norm(rows, axis=-1, keepdims=True), 1e-12)
    p = nullvec_jacobi(rows / norm, sweeps=sweeps)  # (..., 12) row-major vec(P)
    P = p.reshape(*p.shape[:-1], 3, 4)
    R_raw = P[..., :3]
    t_raw = P[..., 3]
    # Fix the projective sign so that det(R) > 0.
    sign = jnp.sign(jnp.linalg.det(R_raw))[..., None, None]
    sign = jnp.where(sign == 0, 1.0, sign)
    R_raw = R_raw * sign
    t_raw = t_raw * sign[..., 0]
    # Orthogonal Procrustes via scaled Newton polish: R_raw = s·R + noise.
    s = jnp.linalg.norm(R_raw, axis=(-2, -1), keepdims=True) / jnp.sqrt(3.0)
    s = jnp.maximum(s, 1e-12)
    R = orthonormalize_rotation(R_raw / s, iters=4)
    t = t_raw / s[..., 0]
    return R, t


def reprojection_errors(
    K: jax.Array, R: jax.Array, t: jax.Array, points3d: jax.Array, points2d: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """(..., M) pixel reprojection error and camera-frame depth.

    Mirrors the reference's inlier test (``loop_closure.cpp:201-215``):
    error = ‖uv − π(K(RX + t))‖, plus z > 0 cheirality.
    """
    cam = jnp.matmul(points3d, jnp.swapaxes(R, -1, -2), precision="highest") + t[..., None, :]
    z = cam[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    pix = jnp.matmul(cam / z_safe[..., None], jnp.swapaxes(K, -1, -2), precision="highest")
    err = jnp.linalg.norm(pix[..., :2] - points2d, axis=-1)
    return err, z


def refine_pnp_gn(
    K: jax.Array,
    R0: jax.Array,  # (..., 3, 3) world→cam
    t0: jax.Array,  # (..., 3)
    points3d: jax.Array,  # (..., M, 3)
    points2d: jax.Array,  # (..., M, 2) pixels
    weights: jax.Array,  # (..., M) — 0/1 inlier weights (or robust weights)
    iters: int = 3,
) -> tuple[jax.Array, jax.Array]:
    """Gauss-Newton pose polish on weighted pixel reprojection error.

    The DLT refit (``solve_pnp_dlt``) minimises an *algebraic* residual and
    costs an 8-sweep one-sided Jacobi — an 88-step sequential rotation chain
    that dominates latency when PnP sits inside the per-frame tracking scan
    (``model/tracking.py``).  Starting from the RANSAC winner, a few GN
    steps on the true geometric residual are both shorter-chained (each
    iteration is one residual/Jacobian evaluation — all parallel over
    points — plus ONE 6×6 solve) and more accurate (pixel error, not
    algebraic error).  Reference analog: none — ``loop_closure.cpp:238-274``
    stops at the raw DLT solution; this exceeds it.

    Left-perturbation parametrisation: T ← Exp(ξ)·T with ξ = (v, w), so
    δXc = v + w × Xc and J = ∂π/∂Xc · [I₃ | −[Xc]ₓ].
    """
    dtype = points3d.dtype
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    R, t = R0, t0

    for _ in range(iters):
        Xc = (
            jnp.matmul(points3d, jnp.swapaxes(R, -1, -2), precision="highest")
            + t[..., None, :]
        )  # (..., M, 3)
        z = Xc[..., 2]
        behind = z <= 1e-6
        z_safe = jnp.where(behind, 1.0, z)
        w = jnp.where(behind, 0.0, weights).astype(dtype)
        inv_z = 1.0 / z_safe
        pix = jnp.matmul(
            Xc * inv_z[..., None], jnp.swapaxes(K, -1, -2), precision="highest"
        )
        r = pix[..., :2] - points2d  # (..., M, 2)
        # ∂π/∂Xc rows: [fx/z, 0, −fx·x/z²], [0, fy/z, −fy·y/z²]
        zero = jnp.zeros_like(z)
        du = jnp.stack(
            [fx[..., None] * inv_z, zero, -fx[..., None] * Xc[..., 0] * inv_z**2],
            axis=-1,
        )  # (..., M, 3)
        dv = jnp.stack(
            [zero, fy[..., None] * inv_z, -fy[..., None] * Xc[..., 1] * inv_z**2],
            axis=-1,
        )
        dpi = jnp.stack([du, dv], axis=-2)  # (..., M, 2, 3)
        eye3 = jnp.broadcast_to(jnp.eye(3, dtype=dtype), Xc.shape[:-1] + (3, 3))
        dXc = jnp.concatenate([eye3, -hat(Xc)], axis=-1)  # (..., M, 3, 6)
        J = jnp.matmul(dpi, dXc, precision="highest")  # (..., M, 2, 6)
        Jw = J * w[..., None, None]
        H = jnp.einsum("...mij,...mik->...jk", Jw, J, precision="highest")
        g = jnp.einsum("...mij,...mi->...j", Jw, r, precision="highest")
        # Tiny relative LM damping keeps the 6×6 solve stable when the
        # inlier set is near-degenerate without biasing converged steps.
        diag = jnp.diagonal(H, axis1=-2, axis2=-1)
        H = H + (1e-6 * diag + 1e-8)[..., None] * jnp.broadcast_to(
            jnp.eye(6, dtype=dtype), H.shape
        )
        delta = -jnp.linalg.solve(H, g[..., None])[..., 0]  # (..., 6)
        delta = jnp.where(jnp.all(jnp.isfinite(delta), axis=-1, keepdims=True),
                          delta, 0.0)
        dR = so3_exp(delta[..., 3:])
        R = jnp.matmul(dR, R, precision="highest")
        t = jnp.matmul(dR, t[..., None], precision="highest")[..., 0] + delta[..., :3]
    return R, t


@partial(
    jax.jit,
    static_argnames=("iters", "min_inliers", "huber_schedule"),
)
def motion_pnp(
    K: jax.Array,
    R0: jax.Array,  # (3, 3) world→cam seed (motion model / two-view prior)
    t0: jax.Array,  # (3,)
    points3d: jax.Array,  # (M, 3) world
    points2d: jax.Array,  # (M, 2) pixels
    valid: jax.Array,  # (M,) bool
    *,
    iters: int = 4,
    reproj_threshold: float = 2.0,
    min_inliers: int = 5,
    huber_schedule: tuple[float, ...] = (16.0, 8.0, 4.0, 2.0),
) -> PnPResult:
    """Seeded robust pose tracking: IRLS Gauss-Newton from a motion prior.

    The per-frame tracking scan (``model/tracking.py``) is latency-bound by
    its *sequential chain*, and RANSAC's hypothesis stage is the longest
    link (a 6-sweep one-sided Jacobi = 66 dependent rotation rounds).  On continuous video the
    previous pose (or the two-view relative pose applied to it) is already
    within a few pixels of the answer, so hypotheses buy nothing: this
    solver just descends — ``iters`` rounds of Huber-reweighted
    Gauss-Newton, each one residual/Jacobian pass (parallel over points)
    plus a single 6×6 solve, with the Huber width annealed from
    ``huber_schedule[0]`` px down so early iterations pull the seed in
    while late ones ignore outliers.  This is the classical motion-model
    tracking optimisation (ORB-SLAM ``TrackWithMotionModel``); the
    reference has no analog — its only PnP is RANSAC inside loop-closure
    verification (``loop_closure.cpp:180-274``), which
    :func:`ransac_pnp` keeps for wide-baseline problems.  Callers guard
    this solver with :func:`ransac_pnp` under a ``lax.cond`` so the long
    chain is paid only on frames where descent from the prior fails.
    """
    dtype = jnp.promote_types(points3d.dtype, jnp.float32)
    X = points3d.astype(dtype)
    uv = points2d.astype(dtype)
    Kf = K.astype(dtype)
    R, t = R0.astype(dtype), t0.astype(dtype)
    vf = valid.astype(dtype)
    fx, fy = Kf[0, 0], Kf[1, 1]

    # Fused IRLS-GN iteration: the Huber weights and the GN step are both
    # evaluated at the SAME (R, t), so one projection/residual pass feeds
    # both (calling reprojection_errors + refine_pnp_gn per iteration
    # recomputed Xc/pix twice at identical poses — this solver sits on the
    # per-frame tracking scan's sequential spine, where op count is the
    # latency; the fusion is numerically identical by construction).
    for i in range(iters):
        delta = huber_schedule[min(i, len(huber_schedule) - 1)]
        Xc = jnp.matmul(X, R.T, precision="highest") + t  # (M, 3)
        z = Xc[:, 2]
        behind = z <= 1e-6
        z_safe = jnp.where(behind, 1.0, z)
        inv_z = 1.0 / z_safe
        pix = jnp.matmul(Xc * inv_z[:, None], Kf.T, precision="highest")
        r = pix[:, :2] - uv  # (M, 2)
        err = jnp.linalg.norm(r, axis=-1)
        # Huber IRLS weight: 1 inside the width, δ/|r| outside; cheirality
        # and validity zero the rest.
        w = vf * jnp.where(
            ~behind, jnp.minimum(1.0, delta / jnp.maximum(err, 1e-9)), 0.0
        )
        zero = jnp.zeros_like(z)
        du = jnp.stack([fx * inv_z, zero, -fx * Xc[:, 0] * inv_z**2], axis=-1)
        dv = jnp.stack([zero, fy * inv_z, -fy * Xc[:, 1] * inv_z**2], axis=-1)
        dpi = jnp.stack([du, dv], axis=-2)  # (M, 2, 3)
        eye3 = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (X.shape[0], 3, 3))
        dXc = jnp.concatenate([eye3, -hat(Xc)], axis=-1)  # (M, 3, 6)
        J = jnp.matmul(dpi, dXc, precision="highest")  # (M, 2, 6)
        Jw = J * w[:, None, None]
        H = jnp.einsum("mij,mik->jk", Jw, J, precision="highest")
        g = jnp.einsum("mij,mi->j", Jw, r, precision="highest")
        diag = jnp.diagonal(H)
        H = H + (1e-6 * diag + 1e-8)[:, None] * jnp.eye(6, dtype=dtype)
        step = -jnp.linalg.solve(H, g[:, None])[:, 0]
        step = jnp.where(jnp.all(jnp.isfinite(step)), step, 0.0)
        dR = so3_exp(step[3:])
        R = jnp.matmul(dR, R, precision="highest")
        t = jnp.matmul(dR, t[:, None], precision="highest")[:, 0] + step[:3]

    err, z = reprojection_errors(Kf, R, t, X, uv)
    inliers = (err < reproj_threshold) & (z > 0) & valid
    count = jnp.sum(inliers.astype(jnp.int32))
    finite = jnp.all(jnp.isfinite(R)) & jnp.all(jnp.isfinite(t))
    success = (count >= min_inliers) & finite
    eye = jnp.eye(3, dtype=dtype)
    return PnPResult(
        R=jnp.where(success, R, eye),
        t=jnp.where(success, t, jnp.zeros(3, dtype)),
        inliers=inliers & success,
        num_inliers=jnp.where(success, count, 0),
        success=success,
    )


@partial(
    jax.jit,
    static_argnames=(
        "num_hypotheses", "sample_size", "min_inliers", "solver_sweeps",
        "hyp_sweeps", "lo_rounds", "refine",
    ),
)
def ransac_pnp(
    points3d: jax.Array,
    points2d: jax.Array,
    valid: jax.Array,
    K: jax.Array,
    key: jax.Array,
    *,
    num_hypotheses: int = 128,
    sample_size: int = 6,
    reproj_threshold: float = 2.0,
    min_inliers: int = 5,
    solver_sweeps: int = 8,
    hyp_sweeps: int | None = None,
    lo_rounds: int = 2,
    refine: str = "dlt",
) -> PnPResult:
    """Batched-RANSAC DLT PnP over (M,) correspondences.

    ``points3d``: (M, 3) world points; ``points2d``: (M, 2) pixels;
    ``valid``: (M,) bool; ``K``: (3, 3).

    ``hyp_sweeps`` (default ``solver_sweeps``) bounds the Jacobi sweeps of
    the *hypothesis* solves only: hypotheses just seed the consensus vote
    and the LO refit polishes the winner, so they tolerate a much shorter
    solve (the same split the essential-matrix RANSAC uses).  Each Jacobi
    sweep is a sequential chain of 11 rotation rounds — on the per-frame
    tracking path (``model/tracking.py``) the solver chain is the dominant
    latency, so ``hyp_sweeps``/``lo_rounds`` are the knobs that matter.

    ``refine`` selects the LO refit: ``"dlt"`` re-solves the weighted DLT
    nullspace (reference-faithful, long Jacobi chain); ``"gn"`` polishes
    the RANSAC winner by Gauss-Newton on the geometric residual
    (:func:`refine_pnp_gn`) — shorter sequential chain, lower pixel error.
    """
    M = points3d.shape[0]
    dtype = jnp.promote_types(points3d.dtype, jnp.float32)
    X = points3d.astype(dtype)
    uv = points2d.astype(dtype)
    Kf = K.astype(dtype)

    # Solve in normalised coordinates: P' = K⁻¹K[R|t] = [R|t].
    fx, fy = Kf[0, 0], Kf[1, 1]
    cx, cy = Kf[0, 2], Kf[1, 2]
    xn = jnp.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], axis=-1)

    # Hypothesis sampling (Gumbel top-k = without replacement over valid).
    # Top-k by iterated argmax+mask: identical indices to ``lax.top_k`` for
    # the tiny k here (ties are measure-zero on float gumbels), cheaper
    # (top_k lowers to a full sort of the M lanes; k argmax
    # reductions don't) — this sits on the per-frame tracking scan's
    # sequential spine, where every dependent step costs throughput.
    g = jax.random.gumbel(key, (num_hypotheses, M), dtype=jnp.float32)
    g = jnp.where(valid[None, :], g, -jnp.inf)
    iota = jnp.arange(M, dtype=jnp.int32)[None, :]
    cols = []
    for _ in range(sample_size):
        i = jnp.argmax(g, axis=1)  # (H,)
        cols.append(i)
        g = jnp.where(iota == i[:, None], -jnp.inf, g)
    sample_idx = jnp.stack(cols, axis=1)  # (H, S)

    R_h, t_h = solve_pnp_dlt(
        X[sample_idx], xn[sample_idx],
        sweeps=solver_sweeps if hyp_sweeps is None else hyp_sweeps,
    )  # (H, 3, 3), (H, 3)

    err, z = reprojection_errors(Kf, R_h, t_h, X, uv)  # (H, M)
    inlier_mat = (err < reproj_threshold) & (z > 0) & valid[None, :]
    counts = jnp.sum(inlier_mat.astype(jnp.int32), axis=-1)
    best_h = jnp.argmax(counts)

    # LO refit on the best consensus set (two rounds, monotone guard).
    R_best, t_best = R_h[best_h], t_h[best_h]
    inliers = inlier_mat[best_h]
    best_count = counts[best_h]
    for _ in range(lo_rounds):
        w = inliers.astype(dtype)
        if refine == "gn":
            R_ref, t_ref = refine_pnp_gn(Kf, R_best, t_best, X, uv, w, iters=3)
        else:
            R_ref, t_ref = solve_pnp_dlt(X, xn, weights=w, sweeps=solver_sweeps)
        err_r, z_r = reprojection_errors(Kf, R_ref, t_ref, X, uv)
        inl_r = (err_r < reproj_threshold) & (z_r > 0) & valid
        cnt_r = jnp.sum(inl_r.astype(jnp.int32))
        better = cnt_r >= best_count
        R_best = jnp.where(better, R_ref, R_best)
        t_best = jnp.where(better, t_ref, t_best)
        inliers = jnp.where(better, inl_r, inliers)
        best_count = jnp.where(better, cnt_r, best_count)

    n_valid = jnp.sum(valid.astype(jnp.int32))
    success = (best_count >= min_inliers) & (n_valid >= sample_size)
    eye = jnp.eye(3, dtype=dtype)
    return PnPResult(
        R=jnp.where(success, R_best, eye),
        t=jnp.where(success, t_best, jnp.zeros(3, dtype)),
        inliers=inliers & success,
        num_inliers=jnp.where(success, best_count, 0),
        success=success,
    )
