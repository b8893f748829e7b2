"""PnP tracking mode (BASELINE config 2): map-anchored absolute poses.

The reference declares the Map-centric design (persistent landmarks,
``include/slam/backend/map.hpp:9-21``) but never implements a tracking loop;
``tpuslam.model.tracking`` is that loop.  These tests run the full pipeline
in ``tracking="pnp"`` mode on the KITTI fixture and check that (a) PnP
actually produces the poses (not the fallback), (b) the trajectory matches
the known straight-ahead motion, and (c) the recovered per-frame baselines
are *more* consistent than VO's chained depth-ratio scale — the property
absolute tracking exists to provide.
"""

import numpy as np
import pytest

from tpuslam.common.camera import Camera
from tpuslam.config.schema import SlamConfig
from tpuslam.model.slam import SlamPipeline
from tpuslam.pre.stream import FrameStream

from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
CONFIGS = REPO_ROOT / "configs"


@pytest.fixture(scope="module")
def results(data_dir):
    camera = Camera.from_yaml(CONFIGS / "camera.yml")
    config = SlamConfig.from_yaml_dir(CONFIGS, batch_size=5)
    out = {}
    for mode in ("vo", "pnp"):
        pipeline = SlamPipeline(camera, config, tracking=mode)
        stream = FrameStream(data_dir / "images")
        run = pipeline.run_pnp if mode == "pnp" else pipeline.run
        out[mode] = run(stream.batches(5))
    return out


def test_pnp_mode_tracks_forward(results):
    poses = results["pnp"]["poses"]
    assert poses.shape == (10, 4, 4)
    pos = poses[:, :3, 3]
    # straight-ahead KITTI motion at map-anchored scale (first pair = unit)
    assert pos[-1, 2] > 6.0
    assert np.abs(pos[:, :2]).max() < 0.6
    R = poses[:, :3, :3]
    rtr = np.einsum("nij,nkj->nik", R, R)
    np.testing.assert_allclose(rtr, np.tile(np.eye(3), (10, 1, 1)), atol=5e-4)


def test_pnp_mode_poses_ok(results):
    ok = results["pnp"]["pose_ok"]
    assert ok[1:].all(), f"pose_ok={ok}"


def test_pnp_steps_more_consistent_than_vo(results):
    """Absolute tracking must not be *worse* than scale chaining on the
    near-constant-speed fixture: compare step-norm spread."""

    def spread(poses):
        steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
        steps = steps[1:]  # first step fixes the gauge
        return float(np.std(steps / np.median(steps)))

    s_pnp = spread(results["pnp"]["poses"])
    s_vo = spread(results["vo"]["poses"])
    assert s_pnp < max(1.5 * s_vo, 0.25), (s_pnp, s_vo)


def test_pnp_map_accumulates_multiview_points(results):
    m = results["pnp"]["map"]
    n_obs = np.asarray(m.obs_mask).sum(axis=0)
    observed = n_obs[np.asarray(m.point_valid)]
    assert observed.size > 200
    frac_multi = (observed >= 2).mean()
    assert frac_multi > 0.3, f"only {frac_multi:.0%} of points have >=2 views"


def test_pnp_tracking_survives_rotation():
    """Associations must survive substantial camera rotation.

    Regression test for the reprojection-gate rotation bug: the gate used a
    double-transposed rotation (computing R_wc(X−C) instead of R_cw(X−C)),
    which only agreed near identity rotation — on a rotated frame every
    association failed the gate and landmark identity died.  Exact synthetic
    correspondences under a 25° rotation must keep ≥80% of associations and
    recover the pose.
    """
    import jax
    import jax.numpy as jnp

    from tpuslam.backend.map import (
        AssocState,
        add_observations,
        empty_map,
        insert_keyframe,
        insert_points,
    )
    from tpuslam.model.tracking import pnp_track_chunk

    rng = np.random.default_rng(3)
    N, k_cap = 256, 512
    K = jnp.asarray(
        [[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]], jnp.float32
    )
    X = rng.uniform([-6, -4, 8], [6, 4, 20], (N, 3)).astype(np.float32)

    def project(Xc):
        pix = Xc @ np.asarray(K).T
        return pix[:, :2] / pix[:, 2:3]

    m = empty_map(window=8, max_points=1024)
    m, slots = insert_points(m, jnp.asarray(X), jnp.ones(N, bool))
    m, kf0 = insert_keyframe(
        m, 0, jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32), True
    )
    uv0 = project(X)
    m = add_observations(m, kf0, slots, jnp.asarray(uv0), jnp.ones(N, bool))

    assoc = AssocState(
        kp_to_point=jnp.full((k_cap,), -1, jnp.int32).at[:N].set(slots),
        kp_birth=jnp.full((k_cap,), -1, jnp.int32)
        .at[:N]
        .set(m.point_birth[slots]),
        prev_kf_slot=jnp.asarray(0, jnp.int32),
        prev_xy=jnp.zeros((k_cap, 2), jnp.float32).at[:N].set(jnp.asarray(uv0)),
    )

    # frame 1: 25° yaw + off-axis translation
    a = np.deg2rad(25.0)
    R_wc = np.asarray(
        [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
        np.float32,
    )
    C = np.asarray([0.6, 0.1, 1.2], np.float32)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, :3] = R_wc
    T_true[:3, 3] = C
    Xc1 = (X - C) @ R_wc  # row-vector form of R_wc.T (X − C)
    assert (Xc1[:, 2] > 1.0).all()
    uv1 = project(Xc1)

    track, m_out, a_out, _ = pnp_track_chunk(
        m,
        assoc,
        K,
        jnp.eye(4, dtype=jnp.float32),
        jnp.asarray([1], jnp.int32),
        jnp.asarray([True]),
        jax.random.split(jax.random.PRNGKey(0), 1),
        jnp.eye(3, dtype=jnp.float32)[None],
        jnp.zeros((1, 3), jnp.float32),
        jnp.asarray([False]),  # no two-view fallback: PnP must carry this
        jnp.zeros((1, k_cap, 2), jnp.float32).at[0, :N].set(jnp.asarray(uv1)),
        jnp.full((1, N), -1, jnp.int32).at[0].set(jnp.arange(N)),
        jnp.full((1, N), -1, jnp.int32).at[0].set(jnp.arange(N)),
        jnp.ones((1, N), bool),
        jnp.zeros((1, N, 3), jnp.float32),
        jnp.zeros((1, N), jnp.float32),
        jnp.zeros((1, N), bool),
    )
    assert bool(track.pnp_ok[0])
    np.testing.assert_allclose(np.asarray(track.poses[0]), T_true, atol=2e-2)
    # the gate must keep the associations alive under rotation
    n_assoc = int((np.asarray(a_out.kp_to_point)[:N] >= 0).sum())
    assert n_assoc >= 0.8 * N, f"only {n_assoc}/{N} associations survived"
    # and the new keyframe must re-observe the landmarks (slot 1)
    n_obs = int(np.asarray(m_out.obs_mask)[1].sum())
    assert n_obs >= 0.8 * N, f"only {n_obs}/{N} re-observations recorded"


@pytest.fixture(scope="module")
def varspeed_results(kitti_frames):
    """Run the variable-speed synthetic scene through BOTH tracking modes."""
    from test_scale_propagation import _render_sequence

    frames = _render_sequence(kitti_frames[0])
    h, w = frames.shape[1:]
    camera = Camera(
        K=np.asarray(
            [[500.0, 0.0, w / 2.0], [0.0, 500.0, h / 2.0], [0.0, 0.0, 1.0]]
        ),
        D=np.zeros(5),
        width=w,
        height=h,
    )
    config = SlamConfig.from_yaml_dir(CONFIGS, batch_size=3)

    def batches():
        B = 3
        n = len(frames)
        for s in range(0, n, B):
            chunk = frames[s : s + B]
            k = len(chunk)
            if k < B:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], B - k, 0)])
            yield chunk, np.zeros(B), np.arange(B) < k

    out = {}
    for mode in ("vo", "pnp"):
        pipeline = SlamPipeline(camera, config, tracking=mode)
        run = pipeline.run_pnp if mode == "pnp" else pipeline.run
        result = run(batches())
        assert result["pose_ok"][1:].all(), (mode, result["pose_ok"])
        out[mode] = np.linalg.norm(
            np.diff(result["poses"][:, :3, 3], axis=0), axis=1
        )
    return out


def test_pnp_tracks_speed_change_better_than_vo(varspeed_results):
    """On a 1→2→1-speed scene, absolute (map-anchored) tracking must beat
    chained depth-ratio scale propagation — this is the property PnP mode
    exists to provide (a test PnP mode can actually fail).
    """
    from test_scale_propagation import STEPS

    want = np.asarray(STEPS) / STEPS[0]

    def profile_err(steps):
        ratios = steps / steps[0]
        return float(np.sqrt(np.mean(((ratios - want) / want) ** 2)))

    err_vo = profile_err(varspeed_results["vo"])
    err_pnp = profile_err(varspeed_results["pnp"])
    assert err_pnp <= err_vo, (err_pnp, err_vo)
