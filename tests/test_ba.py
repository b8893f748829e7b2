"""Map state + sliding-window bundle adjustment tests."""

import jax.numpy as jnp
import numpy as np

from tpuslam.backend.ba import bundle_adjust
from tpuslam.backend.map import add_observations, empty_map, insert_keyframe, insert_points
from tpuslam.common.geometry import so3_exp

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
RNG = np.random.default_rng(9)


def build_synthetic_map(
    n_frames=4, n_points=200, noise_px=0.5, pose_noise=0.02, point_noise=0.05,
    window=8, capacity=512,
):
    """Ground-truth scene + perturbed initialisation stored in a MapState."""
    X_gt = RNG.uniform([-4, -3, 6], [4, 3, 18], size=(n_points, 3))
    Rs, ts = [], []
    for i in range(n_frames):
        w = RNG.normal(size=3) * 0.05
        Rs.append(np.asarray(so3_exp(jnp.asarray(w))))
        ts.append(np.array([0.8 * i, 0.0, 0.0]) + RNG.normal(size=3) * 0.05)
    obs = np.zeros((n_frames, n_points, 2))
    for i in range(n_frames):
        cam = X_gt @ Rs[i].T + ts[i]
        pix = cam @ K.T
        obs[i] = pix[:, :2] / pix[:, 2:]
    obs_noisy = obs + RNG.normal(size=obs.shape) * noise_px

    m = empty_map(window=window, max_points=capacity)
    slots = []
    for i in range(n_frames):
        # perturbed initial poses (pose 0 exact: it is the gauge anchor)
        if i == 0:
            R_init, t_init = Rs[i], ts[i]
        else:
            dw = RNG.normal(size=3) * pose_noise
            R_init = np.asarray(so3_exp(jnp.asarray(dw))) @ Rs[i]
            t_init = ts[i] + RNG.normal(size=3) * pose_noise * 5
        m, s = insert_keyframe(m, i, jnp.asarray(R_init, jnp.float32),
                               jnp.asarray(t_init, jnp.float32))
        slots.append(int(s))
    X_init = X_gt + RNG.normal(size=X_gt.shape) * point_noise
    m, pslots = insert_points(
        m, jnp.asarray(X_init, jnp.float32), jnp.ones(n_points, bool)
    )
    for i, s in enumerate(slots):
        m = add_observations(
            m, jnp.asarray(s), pslots, jnp.asarray(obs_noisy[i], jnp.float32),
            jnp.ones(n_points, bool),
        )
    return m, (np.stack(Rs), np.stack(ts), X_gt)




def _centers(kf_R, kf_t, n):
    return np.stack([-np.asarray(kf_R[i]).T @ np.asarray(kf_t[i]) for i in range(n)])


def _scale_aligned_center_errors(kf_R, kf_t, C_gt):
    """Per-pose camera-centre errors after optimal global scale alignment.

    Monocular BA has a global-similarity gauge freedom (bundle_adjust pins
    the window scale to its INPUT baseline), so raw translation comparisons
    mix real error with the uncorrectable scale component; aligning a
    single scale about the anchor removes exactly the gauge direction and
    nothing else.
    """
    n = len(C_gt)
    C = _centers(kf_R, kf_t, n)
    d = C - C[0]
    dg = np.asarray(C_gt) - np.asarray(C_gt)[0]
    s = float((d * dg).sum() / max((d * d).sum(), 1e-12))
    Ca = C[0] + s * d
    return np.linalg.norm(Ca - (np.asarray(C_gt) - np.asarray(C_gt)[0] + C[0]), axis=1)


def test_map_insertion():
    m = empty_map(window=4, max_points=64)
    m, s0 = insert_keyframe(m, 0, jnp.eye(3), jnp.zeros(3))
    assert int(s0) == 0 and bool(m.kf_valid[0])
    pts = jnp.asarray(RNG.uniform(-1, 1, (10, 3)), jnp.float32)
    m, slots = insert_points(m, pts, jnp.ones(10, bool))
    assert int(m.point_count) == 10
    np.testing.assert_array_equal(np.asarray(slots), np.arange(10))
    # partial validity: only valid points allocated
    m, slots2 = insert_points(m, pts, jnp.asarray([True, False] * 5))
    assert int(m.point_count) == 15
    s2 = np.asarray(slots2)
    assert (s2[1::2] == -1).all()
    assert (s2[0::2] == np.arange(10, 15)).all()


def test_map_point_ring_recycling():
    m = empty_map(window=2, max_points=8)
    pts = jnp.asarray(RNG.uniform(-1, 1, (6, 3)), jnp.float32)
    m, _ = insert_points(m, pts, jnp.ones(6, bool))
    m, slots = insert_points(m, pts, jnp.ones(6, bool))
    s = np.asarray(slots)
    assert (s == np.array([6, 7, 0, 1, 2, 3])).all()


def test_ba_reduces_cost_and_recovers_geometry():
    m, (R_gt, t_gt, X_gt) = build_synthetic_map()
    res = bundle_adjust(m, jnp.asarray(K, jnp.float32), iterations=15)
    assert float(res.final_cost) < float(res.initial_cost) * 0.1
    # poses 1..3 closer to ground truth after BA (modulo the scale gauge)
    C_gt = np.stack([-R.T @ t for R, t in zip(R_gt, t_gt)])
    err_before = _scale_aligned_center_errors(m.kf_R, m.kf_t, C_gt)
    err_after = _scale_aligned_center_errors(res.map.kf_R, res.map.kf_t, C_gt)
    assert err_after[1:].mean() < 0.5 * err_before[1:].mean(), (err_before, err_after)
    for i in range(1, 4):
        R_after = np.asarray(res.map.kf_R[i])
        # orthonormality preserved
        np.testing.assert_allclose(R_after @ R_after.T, np.eye(3), atol=1e-4)


def test_ba_gauge_pose0_fixed():
    m, _ = build_synthetic_map()
    res = bundle_adjust(m, jnp.asarray(K, jnp.float32), iterations=5)
    np.testing.assert_allclose(
        np.asarray(res.map.kf_R[0]), np.asarray(m.kf_R[0]), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(res.map.kf_t[0]), np.asarray(m.kf_t[0]), atol=1e-6
    )


def test_ba_noise_floor():
    """With zero observation noise BA should drive cost to ~0."""
    m, _ = build_synthetic_map(noise_px=0.0, pose_noise=0.01, point_noise=0.02)
    res = bundle_adjust(m, jnp.asarray(K, jnp.float32), iterations=20)
    n_obs = float(jnp.sum(m.obs_mask))
    rms = np.sqrt(2 * float(res.final_cost) / n_obs)  # px RMS (quadratic zone)
    assert rms < 0.1, rms


def test_ba_ignores_unobserved_points():
    m, _ = build_synthetic_map(n_points=100, capacity=512)
    before = np.asarray(m.points[200:])
    res = bundle_adjust(m, jnp.asarray(K, jnp.float32), iterations=5)
    np.testing.assert_array_equal(np.asarray(res.map.points[200:]), before)


def test_ba_robust_to_outlier_observations():
    m, (R_gt, t_gt, X_gt) = build_synthetic_map(n_points=150)
    # corrupt 10% of observations grossly
    obs = np.array(m.obs_uv)  # writable copy
    idx = RNG.choice(150, 15, replace=False)
    obs[1, idx] += RNG.uniform(50, 200, size=(15, 2))
    m = m._replace(obs_uv=jnp.asarray(obs, jnp.float32))
    res = bundle_adjust(m, jnp.asarray(K, jnp.float32), iterations=15)
    # Huber keeps the solution near ground truth despite outliers
    C_gt = np.stack([-R.T @ t for R, t in zip(R_gt, t_gt)])
    err = _scale_aligned_center_errors(res.map.kf_R, res.map.kf_t, C_gt)
    assert (err[1:] < 0.1).all(), err


def test_ba_improves_poses_through_pipeline_map_path():
    """End-to-end data path: chunk arrays → update_map_chunk (association)
    → bundle_adjust reduces *pose error vs ground truth*, not just cost.

    Round 1's pipeline map gave every point one observation, making in-
    pipeline BA inert; this locks the fix in place.
    """
    from tpuslam.backend.map import empty_assoc, update_map_chunk

    rng = np.random.default_rng(4)
    n_pts, B = 256, 4
    Kf = jnp.asarray(K, jnp.float32)
    X_gt = rng.uniform([-8, -5, 8], [8, 5, 30], size=(n_pts, 3))

    # ground-truth forward trajectory (camera centres), first at the origin
    C_gt = np.array([[0, 0, 0], [0.02, 0, 1.0], [0.05, 0.02, 2.0], [0, 0.05, 3.0]])
    R_gt = [np.asarray(so3_exp(jnp.asarray(rng.normal(size=3) * 0.02))) for _ in range(B)]
    R_gt[0] = np.eye(3)

    uv_true = np.zeros((B, n_pts, 2), np.float32)
    X_cam_true = np.zeros((B, n_pts, 3), np.float32)
    for i in range(B):
        cam = (X_gt - C_gt[i]) @ R_gt[i]  # R_cw = R_gtᵀ ⇒ x_c = R_gtᵀ(X−C)
        X_cam_true[i] = cam
        pix = cam @ K.T
        uv_true[i] = pix[:, :2] / pix[:, 2:]

    # noisy estimated poses (frame 0 exact: BA gauge anchor)
    poses = np.zeros((B, 4, 4), np.float32)
    for i in range(B):
        dR = np.eye(3) if i == 0 else np.asarray(so3_exp(jnp.asarray(rng.normal(size=3) * 0.003)))
        dC = 0 if i == 0 else rng.normal(size=3) * 0.015
        poses[i] = np.eye(4)
        poses[i][:3, :3] = R_gt[i] @ dR  # T_world_cam rotation
        poses[i][:3, 3] = C_gt[i] + dC

    # chunk arrays: match j ↔ keypoint j ↔ landmark j in every frame
    idx = jnp.arange(n_pts, dtype=jnp.int32)[None].repeat(B, 0)
    m_valid = jnp.ones((B, n_pts), bool).at[0].set(False)  # no pair for frame 0
    point_ok = m_valid
    kps_xy = jnp.asarray(uv_true + rng.normal(size=uv_true.shape) * 0.3, jnp.float32)
    X_cur = jnp.asarray(
        X_cam_true + rng.normal(size=X_cam_true.shape) * 0.01, jnp.float32
    )

    m0 = empty_map(window=8, max_points=1024)
    a0 = empty_assoc(n_pts)
    m1, _ = update_map_chunk(
        m0, a0, Kf,
        jnp.arange(B, dtype=jnp.int32),
        jnp.ones(B, bool),
        jnp.asarray(poses),
        jnp.ones(B, bool),
        kps_xy, idx, idx, m_valid, X_cur, point_ok,
    )
    nobs = np.asarray(m1.obs_mask).sum(axis=0)
    pv = np.asarray(m1.point_valid)
    assert (nobs[pv] >= 2).mean() > 0.9  # association built multi-view constraints

    ba = bundle_adjust(m1, Kf, iterations=12)
    assert float(ba.final_cost) < 0.5 * float(ba.initial_cost)

    def pose_errors(mm):
        kf_R = np.asarray(mm.kf_R)[:B]
        kf_t = np.asarray(mm.kf_t)[:B]
        rot = []
        for i in range(1, B):
            dR = kf_R[i] @ R_gt[i]  # kf_R is world→cam = R_gtᵀ
            rot.append(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        trans = _scale_aligned_center_errors(kf_R, kf_t, C_gt)[1:]
        return np.mean(rot), np.mean(trans)

    rot0, trans0 = pose_errors(m1)
    rot1, trans1 = pose_errors(ba.map)
    assert rot1 < 0.6 * rot0, f"rotation error {rot0:.5f} -> {rot1:.5f}"
    assert trans1 < 0.6 * trans0, f"translation error {trans0:.4f} -> {trans1:.4f}"


def test_closed_form_blocks_match_jacfwd():
    """The hand-derived Jacobian blocks must equal forward-mode autodiff of
    the delta parameterisation (the formulation they replaced)."""
    import jax

    from tpuslam.backend.ba import _residual_with_delta, _project_residual
    from tpuslam.common.geometry import hat, so3_exp

    key = jax.random.PRNGKey(3)
    K = jnp.asarray([[700.0, 0, 600.0], [0, 700.0, 180.0], [0, 0, 1.0]])
    R = so3_exp(jnp.asarray([0.02, -0.1, 0.03]))
    t = jnp.asarray([0.4, -0.2, 1.5])
    for i in range(5):
        X = jax.random.uniform(
            jax.random.fold_in(key, i), (3,), minval=-3.0, maxval=3.0
        ) + jnp.asarray([0.0, 0.0, 8.0])
        uv = jnp.asarray([300.0, 200.0])
        Ja_ad, Jb_ad = jax.jacfwd(_residual_with_delta, argnums=(0, 1))(
            jnp.zeros(6), jnp.zeros(3), R, t, X, uv, K
        )
        cam = R @ X + t
        z = jnp.maximum(cam[2], 1e-6)
        fx, fy = K[0, 0], K[1, 1]
        j_pi = jnp.asarray(
            [[fx / z, 0.0, -fx * cam[0] / z**2], [0.0, fy / z, -fy * cam[1] / z**2]]
        )
        Ja = jnp.concatenate([-(j_pi @ hat(cam)), j_pi], axis=1)
        Jb = j_pi @ R
        np.testing.assert_allclose(np.asarray(Ja), np.asarray(Ja_ad), atol=1e-4)
        np.testing.assert_allclose(np.asarray(Jb), np.asarray(Jb_ad), atol=1e-4)


def test_active_window_compaction_matches_full():
    """BA over the compacted active-point block must equal BA over the full
    capacity grid when every observed point fits the budget — compaction is
    a pure layout change, not an approximation (and >4× less Hessian work
    at 4096-slot capacity).  Points outside the active set must not move.

    Valid-but-UNOBSERVED points are in the map too: both paths must leave
    them bit-untouched (the gauge renorm restores the window to its input
    scale each step, so unmoved points are already scale-consistent —
    rescaling them would shrink them by the step's drift while the window
    stays put)."""
    m, _ = build_synthetic_map(capacity=512)
    # 30 valid points nobody observes (e.g. out-of-window landmarks in a
    # long PnP-SLAM run)
    extra = jnp.asarray(RNG.uniform([-4, -3, 6], [4, 3, 18], (30, 3)),
                        jnp.float32)
    m, extra_slots = insert_points(m, extra, jnp.ones(30, bool))
    K_j = jnp.asarray(K, jnp.float32)
    full = bundle_adjust(m, K_j, iterations=6, active_points=None)
    compact = bundle_adjust(m, K_j, iterations=6, active_points=256)
    np.testing.assert_allclose(
        np.asarray(full.map.kf_R), np.asarray(compact.map.kf_R), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(full.map.kf_t), np.asarray(compact.map.kf_t), atol=2e-4
    )
    pv = np.asarray(m.point_valid)
    # einsum accumulation order differs between the 512- and 256-slot
    # grids, so float32 drift compounds over the LM iterations — the
    # comparison is layout-equivalence, not bit-equality
    np.testing.assert_allclose(
        np.asarray(full.map.points)[pv],
        np.asarray(compact.map.points)[pv],
        atol=5e-3,
    )
    np.testing.assert_allclose(
        float(full.final_cost), float(compact.final_cost), rtol=1e-3
    )
    # untouched slots (never observed, invalid) keep their buffer contents
    np.testing.assert_array_equal(
        np.asarray(full.map.points)[~pv], np.asarray(compact.map.points)[~pv]
    )
    # valid-but-unobserved points are bit-untouched on BOTH paths
    es = np.asarray(extra_slots)
    np.testing.assert_array_equal(
        np.asarray(full.map.points)[es], np.asarray(extra)
    )
    np.testing.assert_array_equal(
        np.asarray(compact.map.points)[es], np.asarray(extra)
    )


def test_compaction_budget_overflow_keeps_leftovers():
    """With a budget smaller than the observed-point count, the selected
    block optimises and every unselected point keeps its exact value."""
    m, _ = build_synthetic_map(n_points=200, capacity=512)
    K_j = jnp.asarray(K, jnp.float32)
    ba = bundle_adjust(m, K_j, iterations=4, active_points=128)
    moved = ~np.isclose(
        np.asarray(ba.map.points), np.asarray(m.points), atol=1e-7
    ).all(axis=1)
    assert moved.sum() <= 128
    assert moved.sum() > 64  # the budgeted block did optimise
    assert float(ba.final_cost) <= float(ba.initial_cost)


def test_ba_adaptive_rtol_stops_early_at_same_optimum():
    """rtol>0 must stop once accepted steps plateau, reporting the true
    iteration count, and land within a whisker of the fixed-length run."""
    m, _ = build_synthetic_map()
    Kf = jnp.asarray(K, jnp.float32)
    fixed = bundle_adjust(m, Kf, iterations=20)
    adaptive = bundle_adjust(m, Kf, iterations=20, rtol=1e-3)
    assert int(adaptive.iterations) < 20
    assert int(fixed.iterations) == 20
    # Same basin: final cost within 1% of the exhaustive run.
    assert float(adaptive.final_cost) <= float(fixed.final_cost) * 1.01
    # rtol=0 keeps bit-identical fixed-length behaviour.
    fixed2 = bundle_adjust(m, Kf, iterations=20, rtol=0.0)
    np.testing.assert_array_equal(
        np.asarray(fixed.map.kf_t), np.asarray(fixed2.map.kf_t)
    )
