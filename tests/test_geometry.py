"""Geometry primitive tests: batched DLT triangulation, SO(3) utils, hamming."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuslam.common.geometry import (
    closest_rotation,
    compose_se3,
    dehomogenize,
    normalize_points,
    pose_matrix,
    project,
    so3_exp,
    so3_log,
    triangulate_points,
)
from tpuslam.common.hamming import hamming_distance, hamming_matrix, unpack_bits

RNG = np.random.default_rng(0)


def random_rotation(rng):
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * rng.uniform(0.1, 2.5)
    return np.asarray(so3_exp(jnp.asarray(w)))


def test_triangulation_recovers_synthetic_points():
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    R = random_rotation(RNG)
    t = np.array([1.0, 0.2, -0.1])
    X = RNG.uniform([-2, -2, 4], [2, 2, 10], size=(100, 3))

    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([R, t[:, None]])

    uv1, _ = project(jnp.asarray(K), jnp.eye(3), jnp.zeros(3), jnp.asarray(X))
    uv2, _ = project(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t), jnp.asarray(X))

    Xr = triangulate_points(jnp.asarray(P1), jnp.asarray(P2), uv1, uv2)
    np.testing.assert_allclose(np.asarray(Xr), X, rtol=2e-3, atol=2e-3)


def test_triangulation_vmaps_over_pairs():
    K = jnp.asarray([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    P1 = K @ jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)
    Rb = jnp.stack([jnp.eye(3)] * 4)
    tb = jnp.asarray([[0.5 * i + 0.5, 0, 0] for i in range(4)])
    P2 = jnp.einsum("ij,bjk->bik", K, jnp.concatenate([Rb, tb[:, :, None]], axis=2))
    X = jnp.asarray(RNG.uniform([-1, -1, 4], [1, 1, 8], size=(4, 50, 3)), jnp.float32)
    uv1, _ = jax.vmap(lambda x: project(K, jnp.eye(3), jnp.zeros(3), x))(X)
    uv2, _ = jax.vmap(project, in_axes=(None, 0, 0, 0))(K, Rb, tb, X)
    Xr = jax.vmap(triangulate_points, in_axes=(None, 0, 0, 0))(P1, P2, uv1, uv2)
    np.testing.assert_allclose(np.asarray(Xr), np.asarray(X), rtol=5e-3, atol=5e-3)


def test_dehomogenize():
    h = jnp.asarray([[2.0, 4.0, 6.0, 2.0], [1.0, 1.0, 1.0, -0.5]])
    out = np.asarray(dehomogenize(h))
    np.testing.assert_allclose(out[0], [1, 2, 3], atol=1e-6)
    np.testing.assert_allclose(out[1], [-2, -2, -2], atol=1e-6)


def test_so3_roundtrip():
    w = jnp.asarray(RNG.normal(size=(16, 3)) * 0.8)
    R = so3_exp(w)
    w2 = so3_log(R)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w), atol=1e-5)
    # rotations are orthonormal with det +1 (reference test_pose_estimator.cpp:34-43)
    eye = jnp.einsum("bij,bkj->bik", R, R)
    np.testing.assert_allclose(np.asarray(eye), np.stack([np.eye(3)] * 16), atol=1e-6)
    np.testing.assert_allclose(np.asarray(jnp.linalg.det(R)), np.ones(16), atol=1e-6)


def test_closest_rotation():
    R = random_rotation(RNG)
    noisy = R + RNG.normal(size=(3, 3)) * 0.05
    Rp = np.asarray(closest_rotation(jnp.asarray(noisy)))
    np.testing.assert_allclose(Rp @ Rp.T, np.eye(3), atol=1e-6)
    assert np.linalg.det(Rp) == pytest.approx(1.0, abs=1e-6)
    assert np.abs(Rp - R).max() < 0.15


def test_normalize_points():
    K = jnp.asarray([[100.0, 0, 50], [0, 200.0, 60], [0, 0, 1]])
    pts = jnp.asarray([[50.0, 60.0], [150.0, 260.0]])
    norm = np.asarray(normalize_points(K, pts))
    np.testing.assert_allclose(norm, [[0, 0], [1, 1]], atol=1e-6)


def test_compose_and_pose_matrix():
    R1, t1 = random_rotation(RNG), RNG.normal(size=3)
    R2, t2 = random_rotation(RNG), RNG.normal(size=3)
    R, t = compose_se3(jnp.asarray(R1), jnp.asarray(t1), jnp.asarray(R2), jnp.asarray(t2))
    T = np.asarray(pose_matrix(R, t))
    T1 = np.eye(4)
    T1[:3, :3], T1[:3, 3] = R1, t1
    T2 = np.eye(4)
    T2[:3, :3], T2[:3, 3] = R2, t2
    np.testing.assert_allclose(T, T1 @ T2, atol=1e-5)


# --- Hamming ------------------------------------------------------------------


def test_hamming_distance_known_values():
    a = jnp.asarray([0b10110001, 0xFF, 0x00], dtype=jnp.uint8)
    b = jnp.asarray([0b10010011, 0x0F, 0x00], dtype=jnp.uint8)
    assert int(hamming_distance(a, b)) == 2 + 4 + 0


def test_unpack_bits_lsb_first():
    d = jnp.asarray([[0b00000101]], dtype=jnp.uint8)
    bits = np.asarray(unpack_bits(d))[0]
    np.testing.assert_array_equal(bits, [1, 0, 1, 0, 0, 0, 0, 0])


def test_hamming_matrix_paths_agree():
    d1 = jnp.asarray(RNG.integers(0, 256, size=(37, 32)), dtype=jnp.uint8)
    d2 = jnp.asarray(RNG.integers(0, 256, size=(53, 32)), dtype=jnp.uint8)
    m_mat = np.asarray(hamming_matrix(d1, d2, use_matmul=True))
    m_pop = np.asarray(hamming_matrix(d1, d2, use_matmul=False))
    np.testing.assert_array_equal(m_mat, m_pop)
    # against a slow NumPy oracle
    a = np.asarray(d1)
    bnp = np.asarray(d2)
    oracle = np.zeros((37, 53), dtype=np.int32)
    for i in range(37):
        for j in range(53):
            oracle[i, j] = bin(
                int.from_bytes(a[i].tobytes(), "big")
                ^ int.from_bytes(bnp[j].tobytes(), "big")
            ).count("1")
    np.testing.assert_array_equal(m_mat, oracle)


def test_nullvec_minimal_exact():
    """MGS minimal-system nullvector: exact (residual ~1e-7) on random
    8×9 systems, matching the Jacobi solver's subspace."""
    import numpy as np

    from tpuslam.common.geometry import nullvec_minimal

    rng = np.random.default_rng(5)
    A = jnp.asarray(rng.normal(0, 0.5, (64, 8, 9)).astype(np.float32))
    v = nullvec_minimal(A)
    res = jnp.linalg.norm(jnp.einsum("bmn,bn->bm", A, v), axis=-1)
    assert float(jnp.max(res)) < 1e-5
    np.testing.assert_allclose(
        np.asarray(jnp.linalg.norm(v, axis=-1)), 1.0, atol=1e-5
    )
