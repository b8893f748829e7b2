"""Batched RANSAC DLT-PnP tests."""

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.backend.pnp import ransac_pnp, reprojection_errors, solve_pnp_dlt
from tpuslam.common.geometry import so3_exp

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
RNG = np.random.default_rng(5)


def synthetic_pnp(n=60, outlier_frac=0.0, noise_px=0.0, rng=RNG):
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * 0.4
    R = np.asarray(so3_exp(jnp.asarray(w)))
    t = np.array([0.3, -0.2, 0.5])
    X = rng.uniform([-3, -2, 4], [3, 2, 12], size=(n, 3))
    # X in world; camera sees x = R X + t
    cam = X @ R.T + t
    pix = cam @ K.T
    uv = pix[:, :2] / pix[:, 2:]
    uv += rng.normal(size=uv.shape) * noise_px
    n_out = int(n * outlier_frac)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv[idx] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    return X.astype(np.float32), uv.astype(np.float32), R, t


def rot_angle_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def test_dlt_exact_recovery():
    X, uv, R, t = synthetic_pnp(n=30)
    xn = (uv - K[:2, 2]) / np.diag(K)[:2]
    Re, te = solve_pnp_dlt(jnp.asarray(X), jnp.asarray(xn, jnp.float32))
    assert rot_angle_deg(np.asarray(Re), R) < 0.05
    np.testing.assert_allclose(np.asarray(te), t, atol=5e-3)
    # orthonormality
    Re = np.asarray(Re)
    np.testing.assert_allclose(Re @ Re.T, np.eye(3), atol=1e-5)


def test_ransac_pnp_clean():
    X, uv, R, t = synthetic_pnp(n=50)
    res = ransac_pnp(
        jnp.asarray(X), jnp.asarray(uv), jnp.ones(50, bool), jnp.asarray(K),
        jax.random.PRNGKey(0),
    )
    assert bool(res.success)
    assert int(res.num_inliers) == 50
    assert rot_angle_deg(np.asarray(res.R), R) < 0.1
    np.testing.assert_allclose(np.asarray(res.t), t, atol=0.01)


def test_ransac_pnp_outliers():
    X, uv, R, t = synthetic_pnp(n=100, outlier_frac=0.4, noise_px=0.5)
    res = ransac_pnp(
        jnp.asarray(X), jnp.asarray(uv), jnp.ones(100, bool), jnp.asarray(K),
        jax.random.PRNGKey(1), reproj_threshold=2.0,
    )
    assert bool(res.success)
    assert 50 <= int(res.num_inliers) <= 70
    assert rot_angle_deg(np.asarray(res.R), R) < 0.5
    np.testing.assert_allclose(np.asarray(res.t), t, atol=0.05)


def test_ransac_pnp_insufficient():
    X, uv, *_ = synthetic_pnp(n=20)
    valid = np.zeros(20, bool)
    valid[:4] = True  # < sample size 6
    res = ransac_pnp(
        jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(K),
        jax.random.PRNGKey(0),
    )
    assert not bool(res.success)
    np.testing.assert_array_equal(np.asarray(res.R), np.eye(3, dtype=np.float32))


def test_ransac_pnp_min_inliers_gate():
    """Pure-noise correspondences must not 'succeed' (reference gate:
    inliers >= MinInliersForPnP, loop_closure.cpp:224)."""
    X = RNG.uniform([-3, -2, 4], [3, 2, 12], (30, 3)).astype(np.float32)
    uv = RNG.uniform([0, 0], [640, 480], (30, 2)).astype(np.float32)
    res = ransac_pnp(
        jnp.asarray(X), jnp.asarray(uv), jnp.ones(30, bool), jnp.asarray(K),
        jax.random.PRNGKey(2), reproj_threshold=2.0, min_inliers=10,
    )
    assert not bool(res.success)


def test_reprojection_errors_cheirality():
    X, uv, R, t = synthetic_pnp(n=20)
    err, z = reprojection_errors(
        jnp.asarray(K, jnp.float32), jnp.asarray(R, jnp.float32),
        jnp.asarray(t, jnp.float32), jnp.asarray(X), jnp.asarray(uv),
    )
    assert float(jnp.max(err)) < 1e-2
    assert (np.asarray(z) > 0).all()


def test_gn_refine_beats_dlt_refit_on_noise():
    """The GN LO refit must recover the pose at least as well as the DLT
    refit on noisy inliers (it minimises the true pixel error; the DLT
    minimises an algebraic proxy)."""
    X, uv, R, t = synthetic_pnp(n=80, outlier_frac=0.3, noise_px=1.0,
                                rng=np.random.default_rng(11))
    # hyp_sweeps=6 matches the production call sites: the synthetic sweep
    # study showed 3-sweep hypothesis solves collapse the DLT
    # nullspace at >=0.3 px noise, and this fixture has 1.0 px + 30%
    # outliers — the subject here is the LO refit, not hypothesis quality.
    # lo_rounds=3: the absolute-accuracy bars below are platform-sensitive
    # (the same program reads 0.66deg at one LO round on the CPU test
    # platform and 0.0deg on another backend); three rounds converge both.
    kw = dict(reproj_threshold=3.0, hyp_sweeps=6, lo_rounds=3)
    res_dlt = ransac_pnp(
        jnp.asarray(X), jnp.asarray(uv), jnp.ones(80, bool), jnp.asarray(K),
        jax.random.PRNGKey(3), refine="dlt", **kw,
    )
    res_gn = ransac_pnp(
        jnp.asarray(X), jnp.asarray(uv), jnp.ones(80, bool), jnp.asarray(K),
        jax.random.PRNGKey(3), refine="gn", **kw,
    )
    assert bool(res_gn.success)
    ang_gn = rot_angle_deg(np.asarray(res_gn.R), R)
    ang_dlt = rot_angle_deg(np.asarray(res_dlt.R), R)
    assert ang_gn <= ang_dlt + 0.05
    assert ang_gn < 0.5
    np.testing.assert_allclose(np.asarray(res_gn.t), t, atol=0.05)
    # GN pose is a proper rotation
    Rg = np.asarray(res_gn.R)
    np.testing.assert_allclose(Rg @ Rg.T, np.eye(3), atol=1e-5)


def test_gn_refine_exact_noop():
    """At a perfect initial pose with exact correspondences, GN must stay."""
    from tpuslam.backend.pnp import refine_pnp_gn

    X, uv, R, t = synthetic_pnp(n=40, rng=np.random.default_rng(12))
    Rr, tr = refine_pnp_gn(
        jnp.asarray(K, jnp.float32), jnp.asarray(R, jnp.float32),
        jnp.asarray(t, jnp.float32), jnp.asarray(X), jnp.asarray(uv),
        jnp.ones(40, jnp.float32), iters=3,
    )
    assert rot_angle_deg(np.asarray(Rr), R) < 0.02
    np.testing.assert_allclose(np.asarray(tr), t, atol=2e-3)


def test_ransac_pnp_vmappable():
    Xs, uvs = [], []
    for i in range(3):
        X, uv, *_ = synthetic_pnp(n=40, rng=np.random.default_rng(i))
        Xs.append(X)
        uvs.append(uv)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    res = jax.vmap(
        lambda X, uv, k: ransac_pnp(X, uv, jnp.ones(40, bool), jnp.asarray(K), k)
    )(jnp.asarray(np.stack(Xs)), jnp.asarray(np.stack(uvs)), keys)
    assert res.R.shape == (3, 3, 3)
    assert bool(res.success.all())


# --- motion_pnp: seeded Huber-IRLS Gauss-Newton tracking -----------------------


def _perturbed_seed(R, t, rot_deg, t_off, rng):
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * np.radians(rot_deg)
    dR = np.asarray(so3_exp(jnp.asarray(w, jnp.float32)))
    return (dR @ R).astype(np.float32), (t + t_off).astype(np.float32)


def test_motion_pnp_converges_from_motion_prior():
    """From a seed a few degrees / cm off (one inter-frame motion), the
    IRLS-GN tracker must recover the exact pose — this is the healthy path
    of the per-frame tracking scan (model/tracking.py)."""
    from tpuslam.backend.pnp import motion_pnp

    X, uv, R, t = synthetic_pnp(n=60, rng=np.random.default_rng(21))
    R0, t0 = _perturbed_seed(R, t, 3.0, np.array([0.05, -0.03, 0.08]),
                             np.random.default_rng(22))
    res = motion_pnp(
        jnp.asarray(K, jnp.float32), jnp.asarray(R0), jnp.asarray(t0),
        jnp.asarray(X), jnp.asarray(uv), jnp.ones(60, bool),
    )
    assert bool(res.success)
    assert int(res.num_inliers) == 60
    assert rot_angle_deg(np.asarray(res.R), R) < 0.05
    np.testing.assert_allclose(np.asarray(res.t), t, atol=5e-3)
    Rg = np.asarray(res.R)
    np.testing.assert_allclose(Rg @ Rg.T, np.eye(3), atol=1e-5)


def test_motion_pnp_outlier_robust():
    """The annealed Huber weights must reject 30% outliers without RANSAC."""
    from tpuslam.backend.pnp import motion_pnp

    X, uv, R, t = synthetic_pnp(n=100, outlier_frac=0.3, noise_px=0.5,
                                rng=np.random.default_rng(23))
    R0, t0 = _perturbed_seed(R, t, 2.0, np.array([-0.04, 0.02, 0.06]),
                             np.random.default_rng(24))
    res = motion_pnp(
        jnp.asarray(K, jnp.float32), jnp.asarray(R0), jnp.asarray(t0),
        jnp.asarray(X), jnp.asarray(uv), jnp.ones(100, bool),
    )
    assert bool(res.success)
    # inliers ~= the 70 non-outliers (noise may push a couple over 2 px)
    assert 55 <= int(res.num_inliers) <= 75
    assert rot_angle_deg(np.asarray(res.R), R) < 0.3
    np.testing.assert_allclose(np.asarray(res.t), t, atol=0.06)


def test_motion_pnp_fails_without_landmarks():
    """No valid correspondences -> explicit failure, identity pose."""
    from tpuslam.backend.pnp import motion_pnp

    X, uv, R, t = synthetic_pnp(n=30, rng=np.random.default_rng(25))
    res = motion_pnp(
        jnp.asarray(K, jnp.float32), jnp.asarray(R, jnp.float32),
        jnp.asarray(t, jnp.float32), jnp.asarray(X), jnp.asarray(uv),
        jnp.zeros(30, bool),
    )
    assert not bool(res.success)
    np.testing.assert_array_equal(np.asarray(res.R), np.eye(3, dtype=np.float32))


def test_motion_pnp_gated_on_teleport():
    """A wildly wrong seed (relocalization-grade pose error) must not produce
    a confident false pose: either GN fails its inlier floor, or the caller's
    fraction gate rejects it — emulate the tracking scan's gate here."""
    from tpuslam.backend.pnp import motion_pnp

    X, uv, R, t = synthetic_pnp(n=60, rng=np.random.default_rng(26))
    # seed rotated 60 degrees and displaced 4 units: a teleport, not motion
    R0, t0 = _perturbed_seed(R, t, 60.0, np.array([3.0, -2.0, 1.5]),
                             np.random.default_rng(27))
    res = motion_pnp(
        jnp.asarray(K, jnp.float32), jnp.asarray(R0), jnp.asarray(t0),
        jnp.asarray(X), jnp.asarray(uv), jnp.ones(60, bool),
    )
    frac_ok = int(res.num_inliers) >= 0.4 * 60
    accurate = rot_angle_deg(np.asarray(res.R), R) < 1.0
    # Either rejected (tracking falls back / cond runs RANSAC), or the
    # descent actually recovered the true pose — both are safe; a confident
    # wrong pose is not.
    assert (not (bool(res.success) and frac_ok)) or accurate
