"""Two-view pose estimation tests: synthetic ground truth + real frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuslam.common.geometry import hat, so3_exp
from tpuslam.config.schema import DetectorConfig, MatcherConfig
from tpuslam.frontend.detector import FeatureDetector
from tpuslam.frontend.matcher import FeatureMatcher
from tpuslam.frontend.pose import (
    decompose_essential,
    estimate_relative_pose,
    sampson_error_sq,
    triangulate_matched_points,
)

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
RNG = np.random.default_rng(11)


def synthetic_pair(n=100, outlier_frac=0.0, noise_px=0.0, rng=RNG):
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * 0.2
    R = np.asarray(so3_exp(jnp.asarray(w)))
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    X = rng.uniform([-3, -2, 4], [3, 2, 15], size=(n, 3))
    x1 = X @ K.T
    uv1 = x1[:, :2] / x1[:, 2:]
    x2 = (X @ R.T + t) @ K.T
    uv2 = x2[:, :2] / x2[:, 2:]
    uv1 += rng.normal(size=uv1.shape) * noise_px
    uv2 += rng.normal(size=uv2.shape) * noise_px
    n_out = int(n * outlier_frac)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv2[idx] = rng.uniform([0, 0], [640, 480], size=(n_out, 2))
    return uv1.astype(np.float32), uv2.astype(np.float32), R, t, X


def rot_angle_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def test_pose_recovery_clean():
    uv1, uv2, R, t, _ = synthetic_pair(n=80)
    res = estimate_relative_pose(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.ones(80, bool), jnp.asarray(K),
        jax.random.PRNGKey(0),
    )
    assert bool(res.success)
    assert rot_angle_deg(np.asarray(res.R), R) < 0.5
    t_est = np.asarray(res.t)
    cos = abs(t_est @ t / (np.linalg.norm(t_est) * np.linalg.norm(t)))
    assert cos > 0.999
    # rotation orthonormality (reference test_pose_estimator.cpp:34-43)
    Re = np.asarray(res.R)
    np.testing.assert_allclose(Re @ Re.T, np.eye(3), atol=1e-5)
    assert np.linalg.det(Re) == pytest.approx(1.0, abs=1e-5)


def test_pose_recovery_with_outliers_and_noise():
    uv1, uv2, R, t, _ = synthetic_pair(n=200, outlier_frac=0.3, noise_px=0.3)
    res = estimate_relative_pose(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.ones(200, bool), jnp.asarray(K),
        jax.random.PRNGKey(1), inlier_threshold_px=1.5,
    )
    assert bool(res.success)
    assert rot_angle_deg(np.asarray(res.R), R) < 1.0
    t_est = np.asarray(res.t)
    cos = abs(t_est @ t / np.linalg.norm(t_est))
    assert cos > 0.99
    # outliers should be rejected
    assert int(res.num_inliers) >= 120
    assert int(res.num_inliers) <= 160


def test_pose_insufficient_matches():
    uv1, uv2, *_ = synthetic_pair(n=20)
    valid = np.zeros(20, bool)
    valid[:5] = True
    res = estimate_relative_pose(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid), jnp.asarray(K),
        jax.random.PRNGKey(0),
    )
    assert not bool(res.success)
    np.testing.assert_array_equal(np.asarray(res.R), np.eye(3, dtype=np.float32))
    assert int(res.num_inliers) == 0


def test_pose_masked_outliers_excluded():
    uv1, uv2, R, t, _ = synthetic_pair(n=100)
    # corrupt the masked-out tail — must not affect the result
    uv2c = uv2.copy()
    uv2c[80:] = RNG.uniform(0, 600, size=(20, 2))
    valid = np.arange(100) < 80
    res = estimate_relative_pose(
        jnp.asarray(uv1), jnp.asarray(uv2c), jnp.asarray(valid), jnp.asarray(K),
        jax.random.PRNGKey(2),
    )
    assert bool(res.success)
    assert rot_angle_deg(np.asarray(res.R), R) < 0.5
    assert not np.asarray(res.inliers)[80:].any()


def test_decompose_essential_candidates():
    w = RNG.normal(size=3) * 0.3
    R = np.asarray(so3_exp(jnp.asarray(w)))
    t = RNG.normal(size=3)
    t /= np.linalg.norm(t)
    E = np.asarray(hat(jnp.asarray(t))) @ R
    R1, R2, tr = decompose_essential(jnp.asarray(E))
    # t recovered up to sign
    assert min(
        np.linalg.norm(np.asarray(tr) - t), np.linalg.norm(np.asarray(tr) + t)
    ) < 1e-4
    # one of the rotations matches R
    assert min(rot_angle_deg(np.asarray(R1), R), rot_angle_deg(np.asarray(R2), R)) < 0.01
    for Rc in (np.asarray(R1), np.asarray(R2)):
        np.testing.assert_allclose(Rc @ Rc.T, np.eye(3), atol=1e-5)
        assert np.linalg.det(Rc) == pytest.approx(1.0, abs=1e-4)


def test_sampson_zero_for_perfect_matches():
    uv1, uv2, R, t, _ = synthetic_pair(n=50)
    E = np.asarray(hat(jnp.asarray(t))) @ R
    x1 = (uv1 - K[:2, 2]) / np.diag(K)[:2]
    x2 = (uv2 - K[:2, 2]) / np.diag(K)[:2]
    err = np.asarray(
        sampson_error_sq(jnp.asarray(E, jnp.float32), jnp.asarray(x1, jnp.float32),
                         jnp.asarray(x2, jnp.float32))
    )
    assert err.max() < 1e-8


def test_triangulation_roundtrip():
    uv1, uv2, R, t, X = synthetic_pair(n=60)
    Xr = np.asarray(
        triangulate_matched_points(
            jnp.asarray(K), jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32),
            jnp.asarray(uv1), jnp.asarray(uv2),
        )
    )
    np.testing.assert_allclose(Xr, X, rtol=2e-2, atol=2e-2)
    # cheirality: all points in front (reference warns if < 75%)
    assert (Xr[:, 2] > 0).mean() == 1.0


def test_pose_end_to_end_real_frames(kitti_frames):
    """Full two-view VO on consecutive KITTI frames (the de-facto reference
    pipeline, test_pose_estimator.cpp:108-212)."""
    det = FeatureDetector(DetectorConfig(max_keypoints=512))
    matcher = FeatureMatcher(
        MatcherConfig(filter_matches=True, good_matches_count=100, ratio_test_threshold=0.8)
    )
    cam_K = np.array(
        [[984.2439, 0, 690.0], [0, 980.8141, 233.1966], [0, 0, 1.0]]
    )
    k1, d1 = det.detect_and_compute(jnp.asarray(kitti_frames[0]))
    k2, d2 = det.detect_and_compute(jnp.asarray(kitti_frames[1]))
    ms = matcher.match(d1, d2, k1, k2)
    q = np.asarray(ms.query_idx)
    t_idx = np.asarray(ms.train_idx)
    pts1 = jnp.asarray(np.asarray(k1.xy)[np.maximum(q, 0)])
    pts2 = jnp.asarray(np.asarray(k2.xy)[np.maximum(t_idx, 0)])
    res = estimate_relative_pose(
        pts1, pts2, ms.valid, jnp.asarray(cam_K), jax.random.PRNGKey(0),
        inlier_threshold_px=2.0,
    )
    assert bool(res.success)
    R = np.asarray(res.R)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    # KITTI ego-motion between consecutive frames: mostly forward translation,
    # small rotation.
    assert rot_angle_deg(R, np.eye(3)) < 5.0
    tt = np.asarray(res.t)
    assert abs(tt[2]) > 0.7  # dominant z (forward) component
    # >75% of triangulated inlier points in front of camera (reference check)
    X = np.asarray(
        triangulate_matched_points(jnp.asarray(cam_K), res.R, res.t, pts1, pts2)
    )
    inl = np.asarray(res.inliers)
    assert (X[inl, 2] > 0).mean() > 0.75


def test_msac_scores_match_float64_reference():
    """MSAC scores (truncated Sampson loss + invalid-match cap) of the XLA
    path against a float64 NumPy evaluation of the same formula."""
    from tpuslam.frontend.pose import msac_scores

    rng = np.random.default_rng(5)
    h, m = 64, 200
    x1 = rng.uniform(-0.5, 0.5, (m, 2))
    x2 = x1 + rng.normal(0.0, 2e-3, (m, 2))
    E = rng.normal(0.0, 0.3, (h, 3, 3))
    valid = np.arange(m) < 170
    thr = (1.0 / 700.0) ** 2

    x1h = np.concatenate([x1, np.ones((m, 1))], 1)
    x2h = np.concatenate([x2, np.ones((m, 1))], 1)
    ex1 = np.einsum("hij,nj->hni", E, x1h)
    etx2 = np.einsum("hji,nj->hni", E, x2h)
    err = np.einsum("ni,hni->hn", x2h, ex1) ** 2 / (
        ex1[..., 0] ** 2 + ex1[..., 1] ** 2 + etx2[..., 0] ** 2 + etx2[..., 1] ** 2
    )
    want = np.where(valid, np.minimum(err / thr, 1.0), 0.0).sum(-1) + (~valid).sum()

    got = msac_scores(
        jnp.asarray(E, jnp.float32), jnp.asarray(x1, jnp.float32),
        jnp.asarray(x2, jnp.float32), jnp.asarray(valid), jnp.float32(thr),
    )
    assert got.shape == (h,)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-2)
