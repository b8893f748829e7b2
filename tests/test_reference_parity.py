"""ATE parity vs reference numerics — BASELINE.json's accuracy metric.

The oracle trajectory runs the *reference's* pose numerics
(``cv::findEssentialMat`` RANSAC + the float64 ``simpleRecoverPose`` port,
``tests/golden/reference_impl.py``) over the same frontend output; the
framework trajectory is the batched JAX pipeline.  Parity bar: ATE
RMSE after Sim(3) alignment within 5% of the oracle's path length
(monocular scale is a gauge freedom; the reference chains unit baselines).
"""

from pathlib import Path

import numpy as np
import pytest

from tpuslam.post.trajectory import ate_rmse

REPO_ROOT = Path(__file__).resolve().parent.parent
CONFIGS = REPO_ROOT / "configs"


@pytest.fixture(scope="module")
def oracle_poses(data_dir):
    from tools.reference_oracle import oracle_trajectory

    return oracle_trajectory(data_dir / "images", CONFIGS)


@pytest.fixture(scope="module")
def pipeline_poses(data_dir):
    from tpuslam.common.camera import Camera
    from tpuslam.config.schema import SlamConfig
    from tpuslam.model.slam import SlamPipeline
    from tpuslam.pre.stream import FrameStream

    camera = Camera.from_yaml(CONFIGS / "camera.yml")
    config = SlamConfig.from_yaml_dir(CONFIGS, batch_size=5)
    pipeline = SlamPipeline(camera, config)
    stream = FrameStream(data_dir / "images")
    return pipeline.run(stream.batches(5))["poses"]


def test_oracle_is_forward_drive(oracle_poses):
    """Sanity: the reference numerics themselves produce the expected
    straight-ahead KITTI motion (unit-step z, small lateral drift)."""
    pos = oracle_poses[:, :3, 3]
    assert pos[-1, 2] > 7.0
    assert np.abs(pos[:, :2]).max() < 0.5
    R = oracle_poses[:, :3, :3]
    eye = np.einsum("nij,nkj->nik", R, R)
    np.testing.assert_allclose(eye, np.tile(np.eye(3), (len(R), 1, 1)), atol=1e-6)


def test_ate_parity_with_reference_numerics(oracle_poses, pipeline_poses):
    assert pipeline_poses.shape == oracle_poses.shape
    rmse = ate_rmse(pipeline_poses, oracle_poses, align_scale=True)
    steps = np.diff(oracle_poses[:, :3, 3], axis=0)
    path_len = float(np.linalg.norm(steps, axis=1).sum())
    assert rmse < 0.05 * path_len, (
        f"ATE RMSE {rmse:.4f} vs 5% of oracle path length {path_len:.2f}"
    )


@pytest.fixture(scope="module")
def pnp_pipeline_poses(data_dir):
    from tpuslam.common.camera import Camera
    from tpuslam.config.schema import SlamConfig
    from tpuslam.model.slam import SlamPipeline
    from tpuslam.pre.stream import FrameStream

    camera = Camera.from_yaml(CONFIGS / "camera.yml")
    config = SlamConfig.from_yaml_dir(CONFIGS, batch_size=5)
    pipeline = SlamPipeline(camera, config, tracking="pnp")
    stream = FrameStream(data_dir / "images")
    return pipeline.run_pnp(stream.batches(5))["poses"]


def test_ate_parity_pnp_mode(oracle_poses, pnp_pipeline_poses):
    """Map-centric PnP tracking (motion-GN healthy path, model/tracking.py)
    must hold the same 5%-of-path-length parity bar as VO mode — the
    absolute tracker is allowed to *differ* from the reference's chained
    two-view numerics (it is strictly more machinery than the reference
    ever ran), but not to drift from the same fixture trajectory."""
    assert pnp_pipeline_poses.shape == oracle_poses.shape
    rmse = ate_rmse(pnp_pipeline_poses, oracle_poses, align_scale=True)
    steps = np.diff(oracle_poses[:, :3, 3], axis=0)
    path_len = float(np.linalg.norm(steps, axis=1).sum())
    assert rmse < 0.05 * path_len, (
        f"PnP-mode ATE RMSE {rmse:.4f} vs 5% of oracle path length {path_len:.2f}"
    )
