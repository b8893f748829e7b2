"""Nistér 5-point minimal solver tests.

The reference's essential-matrix estimator is ``cv::findEssentialMat``
(``src/frontend/pose_estimator.cpp:42``) — OpenCV's Nistér 5-point inside
sequential RANSAC.  These tests validate the batched JAX solver
(``tpuslam/frontend/fivepoint.py``) three ways: against synthetic ground
truth, against OpenCV's own 5-point solution set (the golden oracle the
reference actually calls), and end-to-end through ``estimate_relative_pose``
with ``sample_size=5`` on contaminated data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuslam.common.geometry import so3_exp
from tpuslam.frontend.fivepoint import fivepoint_essential
from tpuslam.frontend.pose import estimate_relative_pose

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])


def _scene(seed, n=5, rot_scale=0.3):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=3) * rot_scale
    R = np.asarray(so3_exp(jnp.asarray(w)))
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    X = rng.uniform(-2, 2, (n, 3))
    X[:, 2] = rng.uniform(4, 10, n)
    x1 = X[:, :2] / X[:, 2:3]
    Xc = X @ R.T + t
    x2 = Xc[:, :2] / Xc[:, 2:3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    E /= np.linalg.norm(E)
    return x1, x2, E, R, t


def _e_gap(Ea, Eb):
    """Max-abs difference between unit-Frobenius E's, up to global sign."""
    Ea = Ea / np.linalg.norm(Ea)
    Eb = Eb / np.linalg.norm(Eb)
    return min(np.abs(Ea - Eb).max(), np.abs(Ea + Eb).max())


def test_fivepoint_recovers_true_essential_batched():
    B = 128
    x1s, x2s, Es = [], [], []
    for s in range(B):
        x1, x2, E, _, _ = _scene(s)
        x1s.append(x1)
        x2s.append(x2)
        Es.append(E)
    Ec, valid = jax.jit(fivepoint_essential)(
        jnp.asarray(np.stack(x1s), jnp.float32),
        jnp.asarray(np.stack(x2s), jnp.float32),
    )
    Ec, valid = np.asarray(Ec), np.asarray(valid)
    errs = np.full(B, np.inf)
    for b in range(B):
        for k in range(10):
            if valid[b, k]:
                errs[b] = min(errs[b], _e_gap(Ec[b, k], Es[b]))
    # Degenerate-conditioning losses are tolerated (RANSAC redraws);
    # the overwhelming majority of samples must recover the true E.
    assert np.mean(errs < 1e-2) >= 0.85
    assert np.median(errs) < 1e-4
    # Every trial must produce at least one usable candidate.
    assert valid.any(axis=1).mean() >= 0.95


def test_fivepoint_candidates_satisfy_constraints():
    """Valid candidates must satisfy det(E)=0, the trace constraint, and the
    epipolar constraint on their 5 generating points (solver-internal
    consistency, independent of any oracle)."""
    x1, x2, *_ = _scene(3)
    Ec, valid = fivepoint_essential(
        jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32)
    )
    Ec, valid = np.asarray(Ec, np.float64), np.asarray(valid)
    assert valid.any()
    for k in range(10):
        if not valid[k]:
            continue
        E = Ec[k]
        assert abs(np.linalg.det(E)) < 1e-3
        tc = 2 * E @ E.T @ E - np.trace(E @ E.T) * E
        assert np.abs(tc).max() < 1e-2
        for i in range(5):
            v = np.append(x2[i], 1.0) @ E @ np.append(x1[i], 1.0)
            assert abs(v) < 1e-3


def test_fivepoint_matches_opencv_solution_set():
    """Golden test vs the oracle the reference calls: OpenCV's 5-point
    solver returns its full stacked solution set for exactly 5 points; every
    OpenCV solution must appear among this solver's valid candidates."""
    cv2 = pytest.importorskip("cv2")
    matched, total = 0, 0
    for seed in range(8):
        x1, x2, _, _, _ = _scene(seed)
        ocv = cv2.findEssentialMat(
            x1.astype(np.float64),
            x2.astype(np.float64),
            np.eye(3),
            method=cv2.RANSAC,
            prob=0.999,
            threshold=1.0,
        )[0]
        if ocv is None:
            continue
        Ec, valid = fivepoint_essential(
            jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32)
        )
        Ec, valid = np.asarray(Ec), np.asarray(valid)
        ours = [Ec[k] for k in range(10) if valid[k]]
        for j in range(ocv.shape[0] // 3):
            Eo = ocv[3 * j : 3 * j + 3]
            total += 1
            if ours and min(_e_gap(E, Eo) for E in ours) < 5e-3:
                matched += 1
    assert total >= 8
    # f32 vs f64 root-finding keeps a small disagreement tail; the solution
    # sets must overwhelmingly coincide.
    assert matched / total >= 0.8


def test_estimate_relative_pose_5pt_contaminated():
    """End-to-end RANSAC with the 5-point solver on 40%-outlier data: the
    pose must match ground truth, and the minimal solver must get there
    with 8× fewer samples than the 8-point default uses."""
    rng = np.random.default_rng(7)
    n = 200
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * 0.2
    R = np.asarray(so3_exp(jnp.asarray(w)))
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    X = rng.uniform([-3, -2, 4], [3, 2, 15], size=(n, 3))
    p1 = X @ K.T
    uv1 = (p1[:, :2] / p1[:, 2:]).astype(np.float32)
    p2 = (X @ R.T + t) @ K.T
    uv2 = (p2[:, :2] / p2[:, 2:]).astype(np.float32)
    idx = rng.choice(n, int(0.4 * n), replace=False)
    uv2[idx] = rng.uniform([0, 0], [640, 480], size=(len(idx), 2)).astype(
        np.float32
    )

    res = estimate_relative_pose(
        jnp.asarray(uv1),
        jnp.asarray(uv2),
        jnp.ones(n, bool),
        jnp.asarray(K),
        jax.random.PRNGKey(2),
        num_hypotheses=128,
        sample_size=5,
        inlier_threshold_px=1.5,
    )
    assert bool(res.success)
    c = (np.trace(np.asarray(res.R).T @ R) - 1) / 2
    assert np.degrees(np.arccos(np.clip(c, -1, 1))) < 1.0
    t_est = np.asarray(res.t)
    assert abs(t_est @ t / np.linalg.norm(t_est)) > 0.99
    n_in = int(res.num_inliers)
    assert 100 <= n_in <= 140  # the 120 true inliers, minus noise losses
