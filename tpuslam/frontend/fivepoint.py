"""Batched Nistér 5-point minimal solver for the essential matrix.

The reference's ``cv::findEssentialMat`` (``pose_estimator.cpp:42``) is the
Nistér 5-point algorithm inside OpenCV's sequential RANSAC.  A 5-point
sample needs 3 fewer inliers than the repo's 8-point sampler, so at equal
hypothesis count the probability of an all-inlier sample is far higher on
contaminated data — this module supplies that solver in a batched, vectorised form:

  * the 4-dimensional nullspace of each 5×9 epipolar system comes from a
    batched Householder QR (``geometry.nullspace_basis``) — no LAPACK;
  * the ten cubic constraints (det E = 0 and 2 E Eᵀ E − tr(E Eᵀ) E = 0) are
    expanded over the 20 degree-≤3 monomials with *precomputed integer
    multiplication tables*, so constraint assembly is three einsums;
  * the 10×20 system is reduced by an unrolled, partially-pivoted
    Gauss–Jordan (10 static steps, fully batched);
  * Nistér's elimination yields a 3×3 matrix B(z) of z-polynomials whose
    determinant is the classic degree-10 polynomial;
  * real roots come from a fixed-iteration Durand–Kerner solver in
    complex64 on a Fujiwara-balanced polynomial (the raw polynomial's
    leading coefficient is regularly ~1e-6 of its largest, which overflows
    complex64 at the Cauchy radius) — XLA has no batched nonsymmetric ``eig`` on accelerators, and
    Durand–Kerner is pure vectorised arithmetic (all 10 roots of all
    hypotheses in parallel);
  * each real root back-substitutes to (x, y) via the best-conditioned
    2×2 subsystem of B, then a batched Gauss–Newton polish against the
    original 10 cubic constraints recovers float32 machine precision (the
    float32 Gauss–Jordan → det B → roots chain alone is only good to ~2
    digits, measured), giving up to 10 essential-matrix candidates per
    sample with a residual-gated validity mask for the MSAC scorer.

Everything is static-shape and vmappable; degenerate samples or complex
roots simply produce masked-out candidates, never control flow.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from tpuslam.common.geometry import nullspace_basis

# --- monomial bases and multiplication tables (built once at import) -------
# Degree-1 basis: [x, y, z, 1]
_DEG1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
# Degree-2 basis
_DEG2 = [
    (2, 0, 0), (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1),
    (0, 1, 1), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]
# Degree-3 basis in Nistér's elimination order: the first ten monomials are
# the ones Gauss–Jordan solves for; the last ten ("L") are x·z^k, y·z^k and
# pure z^k terms that survive into B(z).
_DEG3 = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    # L block:
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]


def _mul_table(a_basis, b_basis, out_basis) -> np.ndarray:
    out_index = {m: k for k, m in enumerate(out_basis)}
    T = np.zeros((len(a_basis), len(b_basis), len(out_basis)), np.float32)
    for i, ma in enumerate(a_basis):
        for j, mb in enumerate(b_basis):
            prod = tuple(ea + eb for ea, eb in zip(ma, mb))
            T[i, j, out_index[prod]] = 1.0
    return T


# NumPy (not jnp) on purpose: this module is imported lazily, possibly
# inside a jit trace, and a module-level ``jnp.asarray`` created during
# tracing would leak that trace's tracer into later traces.  einsum embeds
# NumPy operands as constants per-trace.
_T11 = _mul_table(_DEG1, _DEG1, _DEG2)  # (4, 4, 10)
_T21 = _mul_table(_DEG2, _DEG1, _DEG3)  # (10, 4, 20)


def _p11(a: jax.Array, b: jax.Array) -> jax.Array:
    """(…, 4) × (…, 4) degree-1 polynomials → (…, 10) degree-2."""
    return jnp.einsum("...i,...j,ijk->...k", a, b, _T11, precision="highest")


def _p21(a: jax.Array, b: jax.Array) -> jax.Array:
    """(…, 10) × (…, 4) → (…, 20) degree-3."""
    return jnp.einsum("...i,...j,ijk->...k", a, b, _T21, precision="highest")


def _constraint_matrix(basis: jax.Array) -> jax.Array:
    """The 10×20 cubic-constraint matrix from a nullspace basis.

    ``basis``: (..., 9, 4) — columns are the X, Y, Z, W basis matrices
    (row-major 3×3), so E(x,y,z) = x·X + y·Y + z·Z + W.  Returns
    (..., 10, 20) coefficients over ``_DEG3``.
    """
    E = basis.reshape(*basis.shape[:-2], 3, 3, 4)  # entries as deg-1 polys

    def e(i, j):
        return E[..., i, j, :]

    # det(E) = 0 — one cubic.
    def det2(i1, j1, i2, j2, i3, j3, i4, j4):
        return _p11(e(i1, j1), e(i2, j2)) - _p11(e(i3, j3), e(i4, j4))

    det = (
        _p21(det2(1, 1, 2, 2, 1, 2, 2, 1), e(0, 0))
        + _p21(det2(1, 2, 2, 0, 1, 0, 2, 2), e(0, 1))
        + _p21(det2(1, 0, 2, 1, 1, 1, 2, 0), e(0, 2))
    )  # (..., 20)

    # 2 E Eᵀ E − tr(E Eᵀ) E = 0 — nine cubics.
    EEt = jnp.einsum(
        "...ika,...jkb,abc->...ijc", E, E, _T11
    , precision="highest")  # (..., 3, 3, 10)
    tr = EEt[..., 0, 0, :] + EEt[..., 1, 1, :] + EEt[..., 2, 2, :]
    M = 2.0 * EEt - tr[..., None, None, :] * jnp.eye(3, dtype=basis.dtype)[
        ..., :, :, None
    ]
    C = jnp.einsum(
        "...ika,...kjb,abc->...ijc", M, E, _T21
    , precision="highest")  # (..., 3, 3, 20)
    return jnp.concatenate(
        [det[..., None, :], C.reshape(*C.shape[:-3], 9, 20)], axis=-2
    )


def _gauss_jordan(A: jax.Array) -> jax.Array:
    """Reduced row echelon form of (..., 10, 20), batched, partial pivoting.

    Ten unrolled elimination steps; pivot row chosen by max |column| among
    the not-yet-pivoted rows (a batched argmax + gather row swap).  Returns
    the right 10×10 block R, so that monomial_i = −R[i] · L for the first
    ten monomials of ``_DEG3``.
    """
    m = A.shape[-2]
    rows = jnp.arange(m)
    for k in range(m):
        col = jnp.abs(A[..., :, k])
        col = jnp.where(rows >= k, col, -1.0)
        p = jnp.argmax(col, axis=-1)  # (...,)
        # Swap rows k and p.
        perm = jnp.where(
            rows == k,
            p[..., None],
            jnp.where(rows == p[..., None], k, rows),
        )
        A = jnp.take_along_axis(A, perm[..., :, None], axis=-2)
        piv = A[..., k, k][..., None]
        piv = jnp.where(jnp.abs(piv) < 1e-20, 1e-20, piv)
        rk = A[..., k, :] / piv
        factors = jnp.where(rows == k, 0.0, A[..., :, k])
        A = A - factors[..., :, None] * rk[..., None, :]
        A = A.at[..., k, :].set(rk)
    return A[..., :, m:]  # (..., 10, 10)


def _polymul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Product of batched z-polynomials, coefficients highest-degree first."""
    la = a.shape[-1]
    lb = b.shape[-1]
    out = jnp.zeros((*a.shape[:-1], la + lb - 1), a.dtype)
    for i in range(la):
        out = out.at[..., i : i + lb].add(a[..., i : i + 1] * b)
    return out


def _b_rows(R: jax.Array):
    """Nistér's B(z) from the reduced system.

    Row pairs (4,5), (6,7), (8,9) of the RREF correspond to monomials
    (x²z, x²), (y²z, y²), (xyz, xy); subtracting z× the second from the
    first eliminates the quadratic terms, leaving three equations linear in
    (x, y) with z-polynomial coefficients:

        Px(z)·x + Py(z)·y + Pc(z) = 0,  deg Px = deg Py = 3, deg Pc = 4.

    Returns (Px, Py, Pc) stacked over the three rows: shapes
    (..., 3, 4), (..., 3, 4), (..., 3, 5), highest degree first.
    """
    ra = R[..., 4::2, :]  # rows for x²z, y²z, xyz   (..., 3, 10)
    rb = R[..., 5::2, :]  # rows for x²,  y²,  xy
    Px = jnp.stack(
        [-rb[..., 0], ra[..., 0] - rb[..., 1], ra[..., 1] - rb[..., 2],
         ra[..., 2]], axis=-1,
    )
    Py = jnp.stack(
        [-rb[..., 3], ra[..., 3] - rb[..., 4], ra[..., 4] - rb[..., 5],
         ra[..., 5]], axis=-1,
    )
    Pc = jnp.stack(
        [-rb[..., 6], ra[..., 6] - rb[..., 7], ra[..., 7] - rb[..., 8],
         ra[..., 8] - rb[..., 9], ra[..., 9]], axis=-1,
    )
    return Px, Py, Pc


def _det_b(Px: jax.Array, Py: jax.Array, Pc: jax.Array) -> jax.Array:
    """det B(z): the degree-10 polynomial, (..., 11) highest-degree first."""

    def row(P, i):
        return P[..., i, :]

    m1 = _polymul(row(Py, 1), row(Pc, 2)) - _polymul(row(Pc, 1), row(Py, 2))
    m2 = _polymul(row(Px, 1), row(Pc, 2)) - _polymul(row(Pc, 1), row(Px, 2))
    m3 = _polymul(row(Px, 1), row(Py, 2)) - _polymul(row(Py, 1), row(Px, 2))
    return (
        _polymul(row(Px, 0), m1)
        - _polymul(row(Py, 0), m2)
        + _polymul(row(Pc, 0), m3)
    )


_EXP3 = np.asarray(_DEG3, np.int32)  # (20, 3) exponents of x, y, z


def _mon_and_jac(x: jax.Array, y: jax.Array, z: jax.Array):
    """Degree-3 monomial vector and its Jacobian at batched (x, y, z).

    Returns ``(mon (..., 20), jac (..., 20, 3))`` over ``_DEG3``.  Twenty
    tiny closed-form products — cheap VPU arithmetic, fully batched.
    """
    pows = {}
    for var, v in (("x", x), ("y", y), ("z", z)):
        one = jnp.ones_like(v)
        pows[var] = [one, v, v * v, v * v * v]
    mon_cols, jac_cols = [], []
    for ex, ey, ez in _DEG3:
        px, py, pz = pows["x"][ex], pows["y"][ey], pows["z"][ez]
        mon_cols.append(px * py * pz)
        dx = ex * pows["x"][ex - 1] * py * pz if ex else jnp.zeros_like(x)
        dy = ey * px * pows["y"][ey - 1] * pz if ey else jnp.zeros_like(x)
        dz = ez * px * py * pows["z"][ez - 1] if ez else jnp.zeros_like(x)
        jac_cols.append(jnp.stack([dx, dy, dz], axis=-1))
    return jnp.stack(mon_cols, axis=-1), jnp.stack(jac_cols, axis=-2)


def _gauss_newton_polish(
    A: jax.Array, x: jax.Array, y: jax.Array, z: jax.Array, iters: int = 4
):
    """Refine roots of the cubic system A·mon(x,y,z)=0 by Gauss–Newton.

    The Gauss–Jordan → det B(z) → root-finding chain loses ~5 digits in
    float32 (the degree-10 polynomial is badly scaled), but ``A`` itself is
    accurate — it comes straight from an orthonormal nullspace basis.  A few
    batched GN steps on the original 10 constraints recover the roots to
    f32 machine precision; each step is a 3×3 normal-equation solve
    (Cramer), so the whole polish is elementwise arithmetic + tiny einsums.
    """
    for _ in range(iters):
        mon, jac = _mon_and_jac(x, y, z)
        r = jnp.einsum("...ck,...nk->...nc", A, mon, precision="highest")  # (..., 10r, C)
        J = jnp.einsum("...ck,...nkv->...ncv", A, jac, precision="highest")  # (..., 10r, C, 3)
        JtJ = jnp.einsum("...ncv,...ncw->...nvw", J, J, precision="highest")
        Jtr = jnp.einsum("...ncv,...nc->...nv", J, r, precision="highest")
        # Levenberg damping keeps steps sane on near-degenerate samples
        # (and makes the 3×3 solve safely invertible).
        trace = JtJ[..., 0, 0] + JtJ[..., 1, 1] + JtJ[..., 2, 2]
        damp = (1e-6 * trace + 1e-12)[..., None, None]
        JtJ = JtJ + damp * jnp.eye(3, dtype=A.dtype)
        step = jnp.linalg.solve(JtJ, Jtr[..., None])[..., 0]
        step = jnp.clip(step, -1.0, 1.0)
        x = x - step[..., 0]
        y = y - step[..., 1]
        z = z - step[..., 2]
    return x, y, z


def durand_kerner_roots(
    coeffs: jax.Array, iters: int = 48
) -> tuple[jax.Array, jax.Array]:
    """All complex roots of batched polynomials, fixed iteration count.

    ``coeffs``: (..., d+1) real, highest-degree first.  Returns
    ``(roots (..., d) complex64, ok (...,) bool)`` — ``ok`` is False when
    the leading coefficient vanishes (degenerate system).  Durand–Kerner
    is simultaneous Newton on the factorised form; it is pure arithmetic
    (no eigendecomposition), so all roots of all batch elements iterate in
    parallel on the VPU.
    """
    d = coeffs.shape[-1] - 1
    lead = coeffs[..., 0:1]
    ok = jnp.abs(lead[..., 0]) > 1e-12 * jnp.max(jnp.abs(coeffs), axis=-1)
    monic = coeffs / jnp.where(jnp.abs(lead) < 1e-30, 1e-30, lead)

    # Balance by the root-radius substitution z = s·w.  The leading
    # coefficient is regularly ~1e-6 of the largest (measured on the 5-point
    # polynomial), so monic coefficients reach ~1e6 and naive evaluation at
    # the Cauchy radius overflows complex64 (|z|^10 ~ 1e60 → NaN roots).
    # Fujiwara's bound s = 2·max_i |m_i|^(1/i) caps the scaled coefficients
    # at 2^−i ≤ 1; compute them in log space so s^i never materialises.
    i_pow = jnp.arange(1, d + 1, dtype=monic.dtype)
    log_m = jnp.log(jnp.maximum(jnp.abs(monic[..., 1:]), 1e-30))
    log_s = jnp.log(2.0) + jnp.max(log_m / i_pow, axis=-1, keepdims=True)
    log_s = jnp.maximum(log_s, jnp.log(1e-3))  # keep 1/s finite too
    scaled = jnp.sign(monic[..., 1:]) * jnp.exp(log_m - i_pow * log_s)
    monic_c = jnp.concatenate(
        [jnp.ones_like(scaled[..., :1]), scaled], axis=-1
    ).astype(jnp.complex64)
    s = jnp.exp(log_s)

    # All scaled roots lie inside |w| ≤ 1 by construction; start just outside.
    seed = 1.2 * (0.4 + 0.9j) ** jnp.arange(1, d + 1)
    r = jnp.broadcast_to(seed, (*monic.shape[:-1], d)).astype(jnp.complex64)

    def horner(z):
        acc = jnp.broadcast_to(monic_c[..., 0:1], z.shape)
        for i in range(1, d + 1):
            acc = acc * z + monic_c[..., i : i + 1]
        return acc

    eye = jnp.eye(d, dtype=jnp.complex64)
    # Unrolled: at these shapes each iteration is a handful of tiny VPU ops
    # and ``lax.scan``'s per-iteration overhead would dominate.
    for _ in range(iters):
        diff = r[..., :, None] - r[..., None, :]  # (..., d, d)
        diff = diff + eye  # 1s on the diagonal
        denom = jnp.prod(diff, axis=-1)
        denom = jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)
        r = r - horner(r) / denom
    return s.astype(jnp.complex64) * r, ok


def fivepoint_essential(
    x1: jax.Array, x2: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Essential-matrix candidates from 5-point samples, batched.

    ``x1``/``x2``: (..., 5, 2) normalised coordinates.  Returns
    ``(E (..., 10, 3, 3), valid (..., 10) bool)`` — up to ten real
    solutions per sample (Nistér's degree-10 polynomial), masked where the
    root is complex or the back-substitution is ill-conditioned.
    """
    dtype = jnp.promote_types(x1.dtype, jnp.float32)
    u1, v1 = x1[..., 0].astype(dtype), x1[..., 1].astype(dtype)
    u2, v2 = x2[..., 0].astype(dtype), x2[..., 1].astype(dtype)
    one = jnp.ones_like(u1)
    rows = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], axis=-1
    )  # (..., 5, 9)

    basis = nullspace_basis(rows)  # (..., 9, 4)
    A = _constraint_matrix(basis)  # (..., 10, 20)
    R = _gauss_jordan(A)  # (..., 10, 10)
    Px, Py, Pc = _b_rows(R)
    poly = _det_b(Px, Py, Pc)  # (..., 11)

    roots, lead_ok = durand_kerner_roots(poly)
    z_re = jnp.real(roots)
    z_im = jnp.imag(roots)
    # (No polynomial-space Newton polish here: evaluating the raw degree-10
    # polynomial overflows float32 for the large-|z| roots the balanced
    # Durand–Kerner now reaches; the Gauss–Newton polish below refines in
    # the original well-conditioned constraint space instead.)
    real = jnp.abs(z_im) < 5e-2 * (1.0 + jnp.abs(z_re))
    # Roots beyond ~1e3 carry no float32 information (z⁴ terms overflow the
    # back-substitution); clip — the residual gate masks any that mattered.
    z_re = jnp.clip(jnp.nan_to_num(z_re), -1e3, 1e3)

    # Back-substitute (x, y) from the best-conditioned 2×2 subsystem of B.
    def evalp(P, z):
        # P: (..., 3, L), z: (..., 10) → (..., 3, 10)
        acc = jnp.broadcast_to(P[..., :, 0:1], (*z.shape[:-1], 3, z.shape[-1]))
        for i in range(1, P.shape[-1]):
            acc = acc * z[..., None, :] + P[..., :, i : i + 1]
        return acc

    bx = evalp(Px, z_re)  # (..., 3, 10)
    by = evalp(Py, z_re)
    bc = evalp(Pc, z_re)
    # All three row pairs (0,1), (0,2), (1,2); pick max |determinant|.
    pairs = [(0, 1), (0, 2), (1, 2)]
    dets, xs, ys = [], [], []
    for i, j in pairs:
        D = bx[..., i, :] * by[..., j, :] - by[..., i, :] * bx[..., j, :]
        Dx = -bc[..., i, :] * by[..., j, :] + by[..., i, :] * bc[..., j, :]
        Dy = -bx[..., i, :] * bc[..., j, :] + bc[..., i, :] * bx[..., j, :]
        dets.append(D)
        xs.append(Dx)
        ys.append(Dy)
    Ds = jnp.stack(dets, axis=-1)  # (..., 10, 3)
    Xs = jnp.stack(xs, axis=-1)
    Ys = jnp.stack(ys, axis=-1)
    best = jnp.argmax(jnp.abs(Ds), axis=-1, keepdims=True)
    D = jnp.take_along_axis(Ds, best, axis=-1)[..., 0]
    Dx = jnp.take_along_axis(Xs, best, axis=-1)[..., 0]
    Dy = jnp.take_along_axis(Ys, best, axis=-1)[..., 0]
    cond_ok = jnp.abs(D) > 1e-12
    D_safe = jnp.where(cond_ok, D, 1.0)
    x = Dx / D_safe
    y = Dy / D_safe

    # The float32 Gauss–Jordan → det B(z) → roots chain is only good to
    # ~2 digits (measured); polish every root against the original,
    # well-conditioned constraint system and gate on its residual.
    x = jnp.clip(jnp.nan_to_num(x), -1e3, 1e3)
    y = jnp.clip(jnp.nan_to_num(y), -1e3, 1e3)
    x, y, z_re = _gauss_newton_polish(A, x, y, z_re)
    mon, _ = _mon_and_jac(x, y, z_re)
    resid = jnp.linalg.norm(
        jnp.einsum("...ck,...nk->...nc", A, mon, precision="highest"), axis=-1
    )
    # Residual scale: ‖A‖ rows are O(1) (orthonormal basis); monomials grow
    # like max(1,|x|,|y|,|z|)³ — normalise so the gate is scale-free.
    scale = jnp.maximum(
        jnp.maximum(jnp.abs(x), jnp.abs(y)), jnp.maximum(jnp.abs(z_re), 1.0)
    ) ** 3
    converged = resid < 1e-4 * scale

    # E = x·X + y·Y + z·Z + W per root.
    coeff = jnp.stack(
        [x, y, z_re, jnp.ones_like(z_re)], axis=-1
    )  # (..., 10, 4)
    Evec = jnp.einsum("...nc,...ec->...ne", coeff, basis, precision="highest")  # (..., 10, 9)
    E = Evec.reshape(*Evec.shape[:-1], 3, 3)
    valid = real & converged & lead_ok[..., None] & jnp.all(
        jnp.isfinite(Evec), axis=-1
    )
    # Frobenius-normalise so downstream thresholds see consistent scale.
    norm = jnp.linalg.norm(Evec, axis=-1)[..., None, None]
    E = E / jnp.where(norm < 1e-12, 1.0, norm)
    return E, valid
