"""Two-view relative pose: batched-RANSAC essential matrix + cheirality recovery.

Reference pipeline (``src/frontend/pose_estimator.cpp:18-104`` and
``src/frontend/simple_pose_recover.cpp``):

  * require ≥ 8 matches (``pose_estimator.cpp:22-26``);
  * ``cv::findEssentialMat(points1, points2, K, RANSAC)`` — iterative
    hypothesize-and-verify inside OpenCV (defaults: 1 px threshold);
  * normalise points by K (``:53-64``) and recover [R|t] by decomposing E
    into 4 candidates and voting with per-candidate triangulation
    cheirality over *all* matches (``simple_pose_recover.cpp:35-97``);
  * triangulate matched points against P1=K[I|0], P2=K[R|t] (``:69-104``).

Accelerator-first restructuring (SURVEY §7 step 4): RANSAC's sequential
hypothesize-and-verify loop becomes *batched hypothesis evaluation* — all H
8-point samples are drawn up front with ``jax.random``, all H essential
matrices are solved as one batched 9×9 eigenproblem, and all H×M Sampson
errors are scored in one reduction, followed by an argmax and an
inlier-weighted refit.  The 4-candidate cheirality vote triangulates every
candidate × every match in one batched DLT.  No data-dependent control flow:
degenerate inputs yield ``success=False`` and identity pose.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpuslam.common.geometry import (
    normalize_points,
    nullvec_jacobi,
    orthonormalize_rotation,
    triangulate_homogeneous,
)
from tpuslam.config.schema import PoseConfig

_W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


class PoseResult(NamedTuple):
    R: jax.Array  # (3, 3)
    t: jax.Array  # (3,) unit norm
    E: jax.Array  # (3, 3)
    inliers: jax.Array  # (M,) bool
    num_inliers: jax.Array  # () int32
    success: jax.Array  # () bool


def _eight_point_rows(x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Epipolar constraint rows: x2ᵀ E x1 = 0 with E row-major.

    ``x1``/``x2``: (..., N, 2) normalised coords → (..., N, 9).
    """
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = jnp.ones_like(u1)
    return jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], axis=-1
    )


def _solve_e_from_rows(
    rows: jax.Array,
    weights: jax.Array | None = None,
    project: bool = True,
    sweeps: int = 5,
) -> jax.Array:
    """Least-squares essential matrix from constraint rows.

    ``rows``: (..., N, 9); optional weights (..., N).  The nullspace comes
    from one-sided Jacobi directly on the rows (no batched eigh of the 9×9
    normal matrix; Jacobi's column rotations are elementwise work).  With ``project`` the
    result is snapped to the essential manifold (singular values → (1,1,0));
    hypothesis scoring skips this (Sampson scoring is valid for any rank-2-ish
    F) and only the final model is projected.
    """
    if weights is not None:
        rows = rows * weights[..., None]
    e = nullvec_jacobi(rows, sweeps=sweeps)  # (..., 9)
    E = e.reshape(*e.shape[:-1], 3, 3)
    if not project:
        return E
    u, _, vt = jnp.linalg.svd(E)
    s = jnp.asarray([1.0, 1.0, 0.0], dtype=E.dtype)
    return jnp.matmul(u * s[..., None, :], vt, precision="highest")


def sampson_error_sq(
    E: jax.Array, x1: jax.Array, x2: jax.Array, with_denom: bool = False
):
    """Squared Sampson distance (normalised units).

    ``E``: (..., 3, 3); ``x1``/``x2``: (N, 2).  Returns (..., N), and the
    gradient-norm denominator too when ``with_denom``.
    """
    ones = jnp.ones((*x1.shape[:-1], 1), dtype=x1.dtype)
    x1h = jnp.concatenate([x1, ones], axis=-1)  # (N, 3)
    x2h = jnp.concatenate([x2, ones], axis=-1)
    Ex1 = jnp.einsum("...ij,nj->...ni", E, x1h, precision="highest")  # (..., N, 3)
    Etx2 = jnp.einsum("...ji,nj->...ni", E, x2h, precision="highest")
    err = jnp.einsum("ni,...ni->...n", x2h, Ex1, precision="highest")  # (..., N)
    denom = (
        Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    )
    e2 = err**2 / jnp.maximum(denom, 1e-18)
    if with_denom:
        return e2, denom
    return e2


def msac_scores(
    E: jax.Array, x1: jax.Array, x2: jax.Array, valid: jax.Array, thr
) -> jax.Array:
    """MSAC score of each model in ``E`` (..., 3, 3): the Sampson error over
    ``thr``, truncated at 1, summed over matches.

    Invalid matches contribute the truncation cap so degenerate inputs
    don't look artificially good.  XLA fuses the Sampson chain into the
    row sum, so the (..., M) error tensor need not reach device memory.
    """
    err = sampson_error_sq(E, x1, x2)
    trunc = jnp.where(valid, jnp.minimum(err / thr, 1.0), 0.0)
    return jnp.sum(trunc, axis=-1) + jnp.sum(~valid)


def decompose_essential(E: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """E → (R1, R2, t) with det-corrected rotations.

    Mirrors reference ``simple_pose_recover.cpp:6-18``: R1 = U W Vᵀ,
    R2 = U Wᵀ Vᵀ, t = U[:, 2], negating R (not U) when det < 0.
    """
    u, _, vt = jnp.linalg.svd(E)
    W = _W.astype(E.dtype)
    R1 = jnp.matmul(jnp.matmul(u, W, precision="highest"), vt, precision="highest")
    R2 = jnp.matmul(jnp.matmul(u, W.T, precision="highest"), vt, precision="highest")
    R1 = jnp.where(jnp.linalg.det(R1) < 0, -R1, R1)
    R2 = jnp.where(jnp.linalg.det(R2) < 0, -R2, R2)
    # float32 SVD can leave ~1e-2 orthonormality drift; polish with Newton
    # iterations (pure matmuls) to restore R Rᵀ = I to float32 precision.
    R1 = orthonormalize_rotation(R1)
    R2 = orthonormalize_rotation(R2)
    t = u[..., :, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    return R1, R2, t


def _candidate_poses(E: jax.Array) -> tuple[jax.Array, jax.Array]:
    """The four [R|±t] candidates, stacked: (4, 3, 3), (4, 3)."""
    R1, R2, t = decompose_essential(E)
    Rs = jnp.stack([R1, R2, R1, R2])
    ts = jnp.stack([t, t, -t, -t])
    return Rs, ts


def cheirality_votes(
    Rs: jax.Array, ts: jax.Array, x1: jax.Array, x2: jax.Array, valid: jax.Array
) -> jax.Array:
    """Per-candidate count of points in front of both cameras.

    Triangulates every candidate × every match in normalised coordinates
    (the vote of reference ``simple_pose_recover.cpp:67-82``; the reference
    applies K to already-normalised points there — a scale quirk that leaves
    the z-signs essentially unchanged, so the standard formulation is used).
    """
    P1 = jnp.concatenate([jnp.eye(3, dtype=Rs.dtype), jnp.zeros((3, 1), Rs.dtype)], axis=1)
    P2 = jnp.concatenate([Rs, ts[..., :, None]], axis=-1)  # (4, 3, 4)
    # Only the z-signs matter for the vote; 4 Jacobi sweeps are plenty.
    Xh = triangulate_homogeneous(
        P1, P2, jnp.broadcast_to(x1, (4, *x1.shape)),
        jnp.broadcast_to(x2, (4, *x2.shape)), sweeps=4,
    )  # (4, N, 4)
    w = Xh[..., 3]
    w_safe = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    z1 = Xh[..., 2] / w_safe
    X2 = jnp.einsum("cij,cnj->cni", P2, Xh / w_safe[..., None], precision="highest")
    z2 = X2[..., 2]
    front = (z1 > 0) & (z2 > 0) & valid[None, :]
    return jnp.sum(front.astype(jnp.int32), axis=-1)  # (4,)


@partial(
    jax.jit,
    static_argnames=("num_hypotheses", "sample_size", "min_matches"),
)
def estimate_relative_pose(
    pts1: jax.Array,
    pts2: jax.Array,
    valid: jax.Array,
    K: jax.Array,
    key: jax.Array,
    *,
    num_hypotheses: int = 2048,
    sample_size: int = 8,
    inlier_threshold_px: float = 1.0,
    min_matches: int = 8,
) -> PoseResult:
    """Batched-RANSAC two-view pose from matched pixel points.

    ``pts1``/``pts2``: (M, 2) float32 pixel coordinates of matched pairs;
    ``valid``: (M,) bool; ``K``: (3, 3).  All shapes static; vmappable over
    frame pairs.
    """
    M = pts1.shape[0]
    dtype = jnp.promote_types(pts1.dtype, jnp.float32)
    pts1 = pts1.astype(dtype)
    pts2 = pts2.astype(dtype)
    Kf = K.astype(dtype)

    n_valid = jnp.sum(valid.astype(jnp.int32))
    enough = n_valid >= min_matches

    x1 = normalize_points(Kf, pts1)  # (M, 2)
    x2 = normalize_points(Kf, pts2)

    # --- hypothesis sampling: H×S indices over valid matches ----------------
    # Uniform independent draws remapped onto the valid set.  (Gumbel top-k
    # would sample without replacement at the cost of a (H, M) top-k; a
    # duplicate index inside one 8-sample merely wastes that
    # hypothesis, which is noise at H = 2048.)
    valid_rank = jnp.cumsum(valid.astype(jnp.int32)) - 1  # rank among valid
    # lookup: rank -> match index
    rank_to_idx = jnp.zeros((M,), jnp.int32).at[
        jnp.where(valid, valid_rank, M - 1)
    ].max(jnp.arange(M, dtype=jnp.int32))
    r = jax.random.randint(
        key, (num_hypotheses, sample_size), 0, jnp.maximum(n_valid, 1)
    )
    sample_idx = rank_to_idx[r]  # (H, S)

    rows_all = _eight_point_rows(x1, x2)  # (M, 9)
    if sample_size == 5:
        # Nistér 5-point minimal solver (the reference's actual estimator —
        # cv::findEssentialMat is 5-point RANSAC, pose_estimator.cpp:42).
        # Each sample yields up to 10 essential-matrix candidates; invalid
        # ones (complex roots, degenerate samples) are masked out of the
        # MSAC ranking.  5-point samples need 3 fewer inliers than 8-point,
        # so the all-inlier hit rate at equal hypothesis count is far
        # higher on contaminated data.
        from tpuslam.frontend.fivepoint import fivepoint_essential

        E_cand, cand_ok = fivepoint_essential(
            x1[sample_idx], x2[sample_idx]
        )  # (H, 10, 3, 3), (H, 10)
        E_hyp = E_cand.reshape(num_hypotheses * 10, 3, 3)
        hyp_ok = cand_ok.reshape(num_hypotheses * 10)
    else:
        rows = rows_all[sample_idx]  # (H, S, 9)
        # Minimal-sample hypotheses only need to *rank* well — the top-L
        # models are re-solved over all inliers by the LO rounds below at
        # full sweep count — so 3 Jacobi sweeps suffice here (measured:
        # identical winners and rotation errors).  An exact MGS minimal
        # solver (nullvec_minimal) was faster standalone but slower fused
        # into this program (XLA fusion interaction) — keep Jacobi here.
        E_hyp = _solve_e_from_rows(rows, project=False, sweeps=3)  # (H, 3, 3)
        hyp_ok = None
    n_models = E_hyp.shape[0]

    # --- score all hypotheses (MSAC: truncated-loss sum) ----------------------
    # MSAC discriminates models far better than raw inlier counting when
    # minimal 8-point hypotheses are noisy.
    focal = 0.5 * (Kf[0, 0] + Kf[1, 1])
    thr = (inlier_threshold_px / focal) ** 2
    msac = msac_scores(E_hyp, x1, x2, valid, thr)
    if hyp_ok is not None:
        # Masked 5-point candidates rank last (worst possible score is M).
        msac = jnp.where(hyp_ok, msac, jnp.float32(M + 1))

    # --- multi-start annealed local optimisation (LO-RANSAC) ------------------
    # Take the top-L hypotheses and run Sampson-weighted least-squares refits
    # with an annealed inlier band (16× → 4× → 1× threshold).  A refit is
    # kept only if it improves the MSAC score (monotone guard), and the best
    # model across all starts and rounds wins.  All L starts refit in one
    # batched solve — this is the batched replacement for OpenCV's sequential
    # hypothesize-and-verify with local optimisation.
    L = min(4, n_models)
    _, top_h = jax.lax.top_k(-msac, L)
    E_cur = E_hyp[top_h]  # (L, 3, 3)
    E_best_l = E_cur
    msac_best_l = msac[top_h]
    rows_b = jnp.broadcast_to(rows_all, (L, *rows_all.shape))
    # Annealed band 16× → 4× → 1×; a fourth repeat round at 1× measured no
    # quality change (pose tests + ATE parity identical) and costs a full
    # refit chain.
    for mult in (16.0, 4.0, 1.0):
        e2, den = sampson_error_sq(E_cur, x1, x2, with_denom=True)  # (L, M)
        w = jnp.where((e2 < mult * thr) & valid[None, :], 1.0, 0.0)
        w = w / jnp.sqrt(jnp.maximum(den, 1e-18))
        E_new = _solve_e_from_rows(rows_b, w.astype(dtype), project=False)
        msac_new = msac_scores(E_new, x1, x2, valid, thr)
        better = msac_new < msac_best_l
        E_best_l = jnp.where(better[:, None, None], E_new, E_best_l)
        msac_best_l = jnp.where(better, msac_new, msac_best_l)
        E_cur = E_new
    best_l = jnp.argmin(msac_best_l)
    # Project the single winning model onto the essential manifold
    # (hypotheses/refits are scored unprojected, fundamental-matrix style).
    E_raw = E_best_l[best_l]
    u, _, vt = jnp.linalg.svd(E_raw)
    sv = jnp.asarray([1.0, 1.0, 0.0], dtype=E_raw.dtype)
    E_best = jnp.matmul(u * sv[None, :], vt, precision="highest")
    inliers = (sampson_error_sq(E_best, x1, x2) < thr) & valid

    # --- recover [R|t] by cheirality vote ------------------------------------
    Rs, ts = _candidate_poses(E_best)
    # Vote on a 256-point INLIER subsample.  The reference triangulates
    # every match for all 4 candidates (``simple_pose_recover.cpp:67-82``);
    # the z-sign majority between the true candidate and its mirrors is
    # enormous (wrong candidates put ~all points behind a camera), so 256
    # inliers decide it identically while cutting the 4×M batched-Jacobi
    # triangulation ~4× — and voting on RANSAC inliers rather than raw
    # matches removes the outlier dilution the reference's vote tolerates.
    vote_n = min(256, x1.shape[0])
    if vote_n < x1.shape[0]:
        _, vote_idx = jax.lax.top_k(inliers.astype(jnp.int32), vote_n)
        xv1, xv2, vmask = x1[vote_idx], x2[vote_idx], inliers[vote_idx]
    else:
        xv1, xv2, vmask = x1, x2, inliers
    votes = cheirality_votes(Rs, ts, xv1, xv2, vmask)
    best_c = jnp.argmax(votes)
    R = Rs[best_c]
    t = ts[best_c]

    success = enough & (jnp.sum(inliers.astype(jnp.int32)) >= min_matches)
    eye = jnp.eye(3, dtype=dtype)
    return PoseResult(
        R=jnp.where(success, R, eye),
        t=jnp.where(success, t, jnp.zeros(3, dtype)),
        E=E_best,
        inliers=inliers & success,
        num_inliers=jnp.where(success, jnp.sum(inliers.astype(jnp.int32)), 0),
        success=success,
    )


@jax.jit
def triangulate_matched_points(
    K: jax.Array, R: jax.Array, t: jax.Array, pts1: jax.Array, pts2: jax.Array
) -> jax.Array:
    """Triangulate matched pixel points against P1=K[I|0], P2=K[R|t].

    Equivalent of reference ``PoseEstimator::triangulatePoints``
    (``pose_estimator.cpp:69-104``) as one batched DLT; internally solves in
    normalised camera coordinates for float32 conditioning (same optimum).
    """
    dtype = jnp.promote_types(pts1.dtype, jnp.float32)
    Kf = K.astype(dtype)
    x1 = normalize_points(Kf, pts1.astype(dtype))
    x2 = normalize_points(Kf, pts2.astype(dtype))
    P1 = jnp.concatenate([jnp.eye(3, dtype=dtype), jnp.zeros((3, 1), dtype)], axis=1)
    P2 = jnp.concatenate([R.astype(dtype), t.astype(dtype)[:, None]], axis=1)
    Xh = triangulate_homogeneous(P1, P2, x1, x2)
    w = Xh[..., 3:4]
    w_safe = jnp.where(jnp.abs(w) < 1e-12, jnp.where(w < 0, -1e-12, 1e-12), w)
    return Xh[..., :3] / w_safe


class PoseEstimator:
    """Config-bound facade mirroring the reference ``PoseEstimator``."""

    def __init__(self, camera, config: PoseConfig | None = None):
        self.camera = camera
        self.config = config or PoseConfig()
        self._K = jnp.asarray(camera.K, dtype=jnp.float32)

    def estimate(self, pts1, pts2, valid, key=None) -> PoseResult:
        c = self.config
        if key is None:
            key = jax.random.PRNGKey(c.seed)
        return estimate_relative_pose(
            pts1,
            pts2,
            valid,
            self._K,
            key,
            num_hypotheses=c.num_hypotheses,
            sample_size=c.sample_size,
            inlier_threshold_px=c.inlier_threshold_px,
            min_matches=c.min_matches,
        )

    def triangulate_points(self, R, t, pts1, pts2) -> jax.Array:
        return triangulate_matched_points(self._K, R, t, pts1, pts2)
