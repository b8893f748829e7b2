"""Batched projective geometry primitives.

The reference triangulates one point at a time with a 4×4 SVD
(``common.hpp:201-221``) and solves PnP/essential decompositions with
per-instance LAPACK SVDs in float64.  Batched small SVD/eigh are slow
on accelerators, so the nullspace solver here
is a *batched one-sided Jacobi* working directly on the rows — no AᵀA
squaring, float32-safe, with the Givens rotations applied as dynamic-slice
column updates as elementwise work (a Givens matmul would pad tiny
matrices onto a large matrix unit).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _round_robin_schedule(n: int) -> list[list[tuple[int, int]]]:
    """Tournament rounds of disjoint column pairs covering all n(n−1)/2."""
    players: list[int | None] = list(range(n)) + ([None] if n % 2 else [])
    m = len(players)
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            if a is not None and b is not None:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


def nullvec_jacobi(A: jax.Array, sweeps: int = 8) -> jax.Array:
    """Right singular vector of the smallest singular value, batched.

    One-sided Jacobi SVD on ``A`` (..., m, n): orthogonalises column pairs
    with Givens rotations accumulated into V.  Works directly on A — unlike
    eigh(AᵀA) it never squares the condition number, so it stays accurate in
    float32 (the accelerator's native precision) where the reference leans on
    float64 LAPACK SVDs (``common.hpp:214``, ``simple_pose_recover.cpp:29``).

    *Parallel (round-robin) ordering*: each ``fori_loop`` step rotates
    ⌊n/2⌋ disjoint column pairs at once via gathers/scatters on the column
    axis — 3–4× fewer sequential steps than cyclic ordering, and measurably
    better convergence per sweep (parallel orderings are known to converge
    at least as fast; measured |Av| 2e-6 vs 1.5e-2 at equal cost on 8×9
    minimal systems).  Rotations never touch a matrix unit.
    """
    n = A.shape[-1]
    dtype = A.dtype
    eye = jnp.eye(n, dtype=dtype)
    V0 = jnp.broadcast_to(eye, (*A.shape[:-2], n, n))

    rounds = _round_robin_schedule(n)
    n_rounds = len(rounds)
    G = max(len(r) for r in rounds)
    import numpy as _np

    p_s = _np.zeros((n_rounds, G), _np.int32)
    q_s = _np.ones((n_rounds, G), _np.int32)
    m_s = _np.zeros((n_rounds, G), bool)
    for i, r in enumerate(rounds):
        for g, (p, q) in enumerate(r):
            p_s[i, g], q_s[i, g], m_s[i, g] = p, q, True
    p_sched = jnp.asarray(p_s)
    q_sched = jnp.asarray(q_s)
    mask_sched = jnp.asarray(m_s)
    eps = jnp.asarray(1e-30, dtype=dtype)

    def body(i, carry):
        A, V = carry
        r = i % n_rounds
        ps = p_sched[r]
        qs = q_sched[r]
        ms = mask_sched[r]
        cp = jnp.take(A, ps, axis=-1)  # (..., m, G)
        cq = jnp.take(A, qs, axis=-1)
        app = jnp.sum(cp * cp, axis=-2)  # (..., G)
        aqq = jnp.sum(cq * cq, axis=-2)
        apq = jnp.sum(cp * cq, axis=-2)
        # Jacobi rotations zeroing the (p, q) off-diagonals of AᵀA.
        tau = (aqq - app) / (2.0 * jnp.where(jnp.abs(apq) < eps, eps, apq))
        sgn = jnp.where(tau >= 0, 1.0, -1.0).astype(dtype)
        t = sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(jnp.abs(apq) < eps * (app + aqq + eps), 0.0, t)
        t = jnp.where(ms, t, 0.0)  # padded slots rotate by identity
        c = (1.0 / jnp.sqrt(1.0 + t * t))[..., None, :]
        s = t[..., None, :] * c

        def rot(M, mp, mq):
            # disjoint columns within a round → scatters don't collide
            M = M.at[..., :, ps].set(c * mp - s * mq)
            return M.at[..., :, qs].set(s * mp + c * mq)

        A = rot(A, cp, cq)
        vp = jnp.take(V, ps, axis=-1)
        vq = jnp.take(V, qs, axis=-1)
        V = rot(V, vp, vq)
        return A, V

    A, V = jax.lax.fori_loop(0, sweeps * n_rounds, body, (A, V0))
    norms = jnp.linalg.norm(A, axis=-2)  # (..., n) singular values
    idx = jnp.argmin(norms, axis=-1)
    return jnp.take_along_axis(V, idx[..., None, None], axis=-1)[..., 0]


def nullvec_minimal(A: jax.Array) -> jax.Array:
    """Exact nullvector of a *minimal* system (m = n−1 rows), batched.

    Modified Gram-Schmidt orthonormalises the m rows (m sequential but fully
    vectorised steps — vs. sweeps × n(n−1)/2 ≈ 108 dependent steps for the
    Jacobi path at n = 9), then two fixed probe vectors are orthogonalised
    against the row space; the larger residual is the nullvector (both
    probes lying in an (n−1)-dim row space is measure-zero, and degenerate
    samples produce garbage hypotheses under any solver — MSAC ranks them
    out).  Unlike eigh(AᵀA) nothing squares the condition number.  For
    minimal RANSAC samples this is both faster *and* more accurate than
    truncated Jacobi (exact vs. 3-sweep approximation).
    """
    m, n = A.shape[-2:]
    assert m < n, "nullvec_minimal needs an underdetermined system"
    Q = A / jnp.maximum(jnp.linalg.norm(A, axis=-1, keepdims=True), 1e-30)
    arange_m = jnp.arange(m)
    for k in range(m):
        qk = Q[..., k, :]
        qk = qk / jnp.maximum(jnp.linalg.norm(qk, axis=-1, keepdims=True), 1e-30)
        proj = jnp.einsum("...mn,...n->...m", Q, qk)
        mask = (arange_m > k)[..., :, None]
        Q = jnp.where(mask, Q - proj[..., :, None] * qk[..., None, :], Q)
        Q = Q.at[..., k, :].set(qk)
    # Two fixed probes (deterministic, generic directions), orthogonalised
    # against the row space; residual norms decide which survives.
    probes = []
    base = jnp.stack(
        [
            jnp.sin(0.7 + 1.3 * jnp.arange(n, dtype=A.dtype)),
            jnp.cos(0.3 + 2.1 * jnp.arange(n, dtype=A.dtype)),
        ]
    )  # (2, n)
    for i in range(2):
        b = jnp.broadcast_to(base[i], A.shape[:-2] + (n,))
        coef = jnp.einsum("...mn,...n->...m", Q, b)
        r = b - jnp.einsum("...m,...mn->...n", coef, Q)
        # second MGS pass for float32 orthogonality
        coef2 = jnp.einsum("...mn,...n->...m", Q, r)
        probes.append(r - jnp.einsum("...m,...mn->...n", coef2, Q))
    r1, r2 = probes
    n1 = jnp.linalg.norm(r1, axis=-1, keepdims=True)
    n2 = jnp.linalg.norm(r2, axis=-1, keepdims=True)
    v = jnp.where(n1 >= n2, r1, r2)
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)


def nullspace_basis(A: jax.Array) -> jax.Array:
    """Orthonormal basis of the nullspace of a wide matrix, batched.

    ``A``: (..., m, n) with m < n and (generically) full row rank; returns
    (..., n, n-m) whose columns span null(A) exactly.  Householder QR of Aᵀ
    (m reflections, each a batched rank-1 update — no LAPACK, no iteration):
    Aᵀ = QR with Q (n, n); the last n-m columns of Q are the nullspace.
    Used by the 5-point minimal solver, which needs the full 4-dimensional
    nullspace of its 5×9 epipolar system, not just one nullvector.

    Rank-deficient inputs (coincident sample points) produce a subspace that
    is orthogonal but not exactly null — such degenerate RANSAC samples
    yield garbage hypotheses under any solver and are ranked out by MSAC.
    """
    m, n = A.shape[-2:]
    assert m < n, "nullspace_basis needs an underdetermined system"
    dtype = A.dtype
    B = jnp.swapaxes(A, -1, -2)  # (..., n, m)
    rows = jnp.arange(n)
    vs = []
    for k in range(m):
        x = jnp.where(rows >= k, B[..., :, k], 0.0)  # column k below diag
        xnorm = jnp.linalg.norm(x, axis=-1, keepdims=True)
        x0 = x[..., k][..., None]
        # alpha = -sign(x0) * ||x|| avoids cancellation in v = x - alpha e_k
        alpha = -jnp.where(x0 >= 0, 1.0, -1.0) * xnorm
        v = x - alpha * (rows == k).astype(dtype)
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
        B = B - 2.0 * v[..., :, None] * jnp.einsum(
            "...n,...nm->...m", v, B, precision="highest"
        )[..., None, :]
        vs.append(v)
    # Q's trailing columns: q_j = H_0 ··· H_{m-1} e_j for j = m..n-1.
    Ecols = jnp.broadcast_to(
        jnp.eye(n, dtype=dtype)[:, m:], (*A.shape[:-2], n, n - m)
    )
    Q = Ecols
    for v in reversed(vs):
        Q = Q - 2.0 * v[..., :, None] * jnp.einsum(
            "...n,...nk->...k", v, Q, precision="highest"
        )[..., None, :]
    return Q


def smallest_eigvec(ata: jax.Array) -> jax.Array:
    """Eigenvector for the smallest eigenvalue of a batched symmetric matrix.

    ``ata``: (..., n, n) symmetric.  Returns (..., n), unit norm.
    ``eigh`` returns eigenvalues in ascending order, so column 0 is it.
    """
    _, vecs = jnp.linalg.eigh(ata)
    return vecs[..., :, 0]


def _normalize_rows(a: jax.Array, eps: float = 1e-12) -> jax.Array:
    norm = jnp.linalg.norm(a, axis=-1, keepdims=True)
    return a / jnp.maximum(norm, eps)


def triangulate_homogeneous(
    P1: jax.Array, P2: jax.Array, pts1: jax.Array, pts2: jax.Array,
    sweeps: int = 8,
) -> jax.Array:
    """Batched two-view DLT triangulation → homogeneous 4-vectors.

    ``P1``/``P2``: (3, 4) projection matrices (shared across points) or
    (..., 3, 4) batched.  ``pts1``/``pts2``: (..., N, 2) image points.
    Returns (..., N, 4) homogeneous points (unit norm, sign unnormalised).

    Equivalent of the reference's per-point SVD loop ``common.hpp:201-221``,
    restructured as one batched eigh over AᵀA.
    """
    x1 = pts1[..., 0:1]  # (..., N, 1)
    y1 = pts1[..., 1:2]
    x2 = pts2[..., 0:1]
    y2 = pts2[..., 1:2]

    def rows(P, x, y):
        # P: (..., 3, 4) → broadcast rows against (..., N, 1) coords
        p0 = P[..., None, 0, :]  # (..., 1, 4)
        p1 = P[..., None, 1, :]
        p2 = P[..., None, 2, :]
        return x * p2 - p0, y * p2 - p1  # each (..., N, 4)

    r0, r1 = rows(P1, x1, y1)
    r2, r3 = rows(P2, x2, y2)
    A = jnp.stack([r0, r1, r2, r3], axis=-2)  # (..., N, 4, 4)
    A = _normalize_rows(A)
    # Column equilibration keeps the Jacobi rotations balanced; the nullspace
    # direction is recovered by unscaling (v = S v').
    col_norm = jnp.maximum(jnp.linalg.norm(A, axis=-2, keepdims=True), 1e-12)
    v = nullvec_jacobi(A / col_norm, sweeps=sweeps)
    v = v / col_norm[..., 0, :]
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)


def dehomogenize(points_h: jax.Array, eps: float = 1e-12) -> jax.Array:
    """(..., 4) homogeneous → (..., 3) Euclidean (guarding w≈0)."""
    w = points_h[..., 3:4]
    w_safe = jnp.where(jnp.abs(w) < eps, jnp.where(w < 0, -eps, eps), w)
    return points_h[..., :3] / w_safe


def triangulate_points(
    P1: jax.Array, P2: jax.Array, pts1: jax.Array, pts2: jax.Array
) -> jax.Array:
    """Batched DLT triangulation → (..., N, 3) Euclidean points."""
    return dehomogenize(triangulate_homogeneous(P1, P2, pts1, pts2))


def project(K: jax.Array, R: jax.Array, t: jax.Array, points3d: jax.Array) -> jax.Array:
    """Project (..., N, 3) world points: returns (..., N, 2) pixels and depth.

    ``x = K (R X + t)``; returns (uv, z) with uv = x[:2]/x[2].
    """
    cam = points3d @ jnp.swapaxes(R, -1, -2) + t[..., None, :]
    pix = cam @ jnp.swapaxes(K, -1, -2)
    z = pix[..., 2:3]
    z_safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    return pix[..., :2] / z_safe, cam[..., 2]


def normalize_points(K: jax.Array, pts: jax.Array) -> jax.Array:
    """Pixel → normalised camera coordinates: (u-cx)/fx, (v-cy)/fy.

    Mirrors reference ``pose_estimator.cpp:53-64``.
    """
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    x = (pts[..., 0] - cx[..., None]) / fx[..., None]
    y = (pts[..., 1] - cy[..., None]) / fy[..., None]
    return jnp.stack([x, y], axis=-1)


def hat(v: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of (..., 3) vectors."""
    zero = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([zero, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], zero, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], zero], axis=-1),
        ],
        axis=-2,
    )


def closest_rotation(M: jax.Array) -> jax.Array:
    """Project (..., 3, 3) matrices onto SO(3) (Procrustes, det +1).

    Used by PnP to orthogonalise the DLT rotation block
    (reference ``loop_closure.cpp:262-270``).
    """
    u, _, vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(u @ vt)
    d = jnp.ones_like(det)
    corr = jnp.stack([d, d, det], axis=-1)
    return (u * corr[..., None, :]) @ vt


def orthonormalize_rotation(R: jax.Array, iters: int = 3) -> jax.Array:
    """Newton iteration for the orthogonal polar factor: R ← R(3I − RᵀR)/2.

    Quadratically convergent for matrices near SO(3); pure matmuls, so it
    fixes the float32 drift of small-SVD pipelines without another SVD.
    """
    eye = jnp.eye(3, dtype=R.dtype)
    for _ in range(iters):
        # f32 matmuls default to reduced precision on accelerators (TF32 on
        # GPUs); the polar
        # Newton iteration needs true f32.
        RtR = jnp.matmul(jnp.swapaxes(R, -1, -2), R, precision="highest")
        R = jnp.matmul(R, 1.5 * eye - 0.5 * RtR, precision="highest")
    return R


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues exponential map (..., 3) → (..., 3, 3) rotation matrices.

    Autodiff-safe at w = 0 (Taylor-switched coefficients; ``norm`` has a NaN
    gradient at zero, which would poison BA's ``jacfwd`` at the linearisation
    point).
    """
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    Kx = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), Kx.shape)
    return eye + a * Kx + b * (Kx @ Kx)


def so3_log(R: jax.Array) -> jax.Array:
    """Log map (..., 3, 3) → (..., 3) rotation vectors (principal branch).

    Autodiff-safe at the identity: ``arccos`` has an infinite derivative at
    cos θ = 1, which is exactly where pose-graph/BA residuals linearise, so
    the small-angle branch switches on the *input* (Taylor scale
    0.5 + (1 − cos θ)/6) before arccos ever sees a value near 1.
    Angles near π are clamped (not reached by incremental SLAM edges).
    """
    trace = jnp.trace(R, axis1=-2, axis2=-1)
    cos_theta = jnp.clip((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0)
    small = cos_theta > 1.0 - 1e-6
    cos_safe = jnp.where(small, 0.0, cos_theta)
    theta = jnp.arccos(cos_safe)
    sin_safe = jnp.sqrt(jnp.maximum(1.0 - cos_safe * cos_safe, 1e-12))
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    scale = jnp.where(
        small, 0.5 + (1.0 - cos_theta) / 6.0, theta / (2.0 * sin_safe)
    )
    return w * scale[..., None]


def compose_se3(R1, t1, R2, t2):
    """(R1,t1)∘(R2,t2): apply 2 then 1."""
    return R1 @ R2, (R1 @ t2[..., None])[..., 0] + t1


def pose_matrix(R: jax.Array, t: jax.Array) -> jax.Array:
    """Stack (..., 3, 3) + (..., 3) into (..., 4, 4) homogeneous transforms."""
    batch = R.shape[:-2]
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), (*batch, 1, 4)
    )
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)
