"""Variable-speed monocular scale propagation.

The depth-ratio scale chain (``model/slam.py`` step 7) exists to recover
inter-frame speed changes that unit-baseline chaining cannot see.  Round 1
only validated it on the near-constant-speed KITTI fixture; this test
synthesises a sequence with a known 2× speed change and asserts the
recovered step norms track the true speed profile.

Scene construction: four fronto-parallel textured planes at different
depths (multiple depths keep the essential-matrix estimation away from the
single-plane homography degeneracy).  The camera translates forward along
+z with steps [s, s, s, 2s, 2s, 2s, s, s]; each frame is rendered by
scaling the real KITTI fixture texture about the principal point per plane
(pure forward motion toward a fronto-parallel plane is exactly a scaling
homography), compositing far-to-near.
"""

import numpy as np
import pytest

from tpuslam.common.camera import Camera
from tpuslam.config.schema import SlamConfig
from tpuslam.model.slam import SlamPipeline

from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
CONFIGS = REPO_ROOT / "configs"

DEPTHS = (18.0, 26.0, 38.0, 55.0)  # plane depth per vertical strip
STEPS = (0.25, 0.25, 0.25, 0.5, 0.5, 0.5, 0.25, 0.25)


def _render_sequence(texture: np.ndarray):
    import cv2

    h, w = texture.shape
    cx, cy = w / 2.0, h / 2.0
    z = np.concatenate([[0.0], np.cumsum(STEPS)])
    frames = []
    strip_w = w // len(DEPTHS)
    for zi in z:
        frame = np.zeros_like(texture)
        for s_idx, d in enumerate(DEPTHS):  # far strips first (crude occlusion)
            scale = d / (d - zi)
            M = np.asarray(
                [[scale, 0.0, cx * (1 - scale)], [0.0, scale, cy * (1 - scale)]]
            )
            warped = cv2.warpAffine(
                texture, M, (w, h), flags=cv2.INTER_LINEAR
            )
            x0 = s_idx * strip_w
            x1 = w if s_idx == len(DEPTHS) - 1 else (s_idx + 1) * strip_w
            # the strip's region also scales about the principal point
            xs0 = int(round(cx + (x0 - cx) * scale))
            xs1 = int(round(cx + (x1 - cx) * scale))
            xs0, xs1 = max(xs0, 0), min(xs1, w)
            if xs1 > xs0:
                frame[:, xs0:xs1] = warped[:, xs0:xs1]
        frames.append(frame)
    return np.stack(frames)


@pytest.fixture(scope="module")
def recovered_steps(kitti_frames):
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
    pipeline = SlamPipeline(camera, config)

    def batches():
        B = 3
        n = len(frames)
        for s in range(0, n, B):
            chunk = frames[s : s + B]
            k = len(chunk)
            if k < B:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], B - k, 0)])
            yield chunk, np.zeros(B), np.arange(B) < k

    result = pipeline.run(batches())
    poses = result["poses"]
    assert result["pose_ok"][1:].all(), result["pose_ok"]
    return np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)


def test_speed_profile_recovered(recovered_steps):
    """Step-norm *ratios* must track the 1→2→1 speed profile within 12%."""
    ratios = recovered_steps / recovered_steps[0]
    want = np.asarray(STEPS) / STEPS[0]
    np.testing.assert_allclose(ratios, want, rtol=0.12)


def test_forward_motion(recovered_steps):
    # sanity on the synthetic renderer: the pipeline sees forward motion of
    # roughly constant per-segment speed, not noise
    assert recovered_steps.min() > 0


@pytest.fixture(scope="module")
def pnp_recovered_steps(kitti_frames):
    """Same rendered variable-speed scene, tracked map-centrically (PnP)."""
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
    pipeline = SlamPipeline(camera, config, tracking="pnp")

    def batches():
        B = 3
        n = len(frames)
        for s in range(0, n, B):
            chunk = frames[s : s + B]
            k = len(chunk)
            if k < B:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], B - k, 0)])
            yield chunk, np.zeros(B), np.arange(B) < k

    result = pipeline.run_pnp(batches())
    assert result["pose_ok"][1:].all(), result["pose_ok"]
    return np.linalg.norm(np.diff(result["poses"][:, :3, 3], axis=0), axis=1)


def test_pnp_tracks_speed_change_at_least_as_well_as_vo(
    pnp_recovered_steps, recovered_steps
):
    """Absolute map-anchored tracking must beat (or match) scale-chained VO
    exactly where it should shine: a 2x speed change (a PnP
    assertion that can fail).  Measured: PnP 4.9% vs VO 6.8% max
    ratio error on this scene."""
    want = np.asarray(STEPS) / STEPS[0]

    def max_err(steps):
        ratios = steps / steps[0]
        return float(np.abs(ratios / want - 1.0).max())

    e_pnp, e_vo = max_err(pnp_recovered_steps), max_err(recovered_steps)
    assert e_pnp <= 0.10, e_pnp
    assert e_pnp <= e_vo, (e_pnp, e_vo)
