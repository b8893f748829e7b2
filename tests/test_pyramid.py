"""Multi-scale (ORB-style) pyramid detection — BASELINE config 4.

The reference detects on a single scale (``feature_detector.cpp:56-68``);
round 1 measured degraded matching on the blurry indoor ``images_test_loop2``
frames.  These tests check the pyramid's contract: fixed total capacity,
level-0 coordinate mapping, and — the point of the feature — that matching
on the blur-degraded loop fixtures recovers with levels enabled.  Both
reference loop sequences are exercised (``images_test_loop`` was unused in
round 1).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from tpuslam.config.schema import DetectorConfig, MatcherConfig
from tpuslam.frontend.detector import FeatureDetector
from tpuslam.frontend.matcher import match_descriptors

REPO_ROOT = Path(__file__).resolve().parent.parent


def _load(seq: str, idx: int) -> np.ndarray:
    import cv2

    path = REPO_ROOT / "tests" / "data" / seq
    files = sorted(path.glob("*.png"), key=lambda p: p.name)
    img = cv2.imread(str(files[idx]), cv2.IMREAD_GRAYSCALE)
    assert img is not None
    return np.asarray(img, np.uint8)


def _detect(frame: np.ndarray, levels: int) -> tuple:
    cfg = DetectorConfig(
        brief_quantized_bins=16, num_levels=levels, scale_factor=1.4
    )
    det = FeatureDetector(cfg)
    kps, desc = det.detect_and_compute_batch(jnp.asarray(frame)[None])
    return (
        type(kps)(*(np.asarray(a)[0] for a in kps)),
        np.asarray(desc)[0],
    )


def _match_count(frame_a: np.ndarray, frame_b: np.ndarray, levels: int) -> int:
    cfg = DetectorConfig(
        brief_quantized_bins=16, num_levels=levels, scale_factor=1.4
    )
    det = FeatureDetector(cfg)
    mcfg = MatcherConfig()
    frames = jnp.asarray(np.stack([frame_a, frame_b]))
    kps, desc = det.detect_and_compute_batch(frames)
    match = match_descriptors(
        desc[0], desc[1], kps.valid[0], kps.valid[1], kps.xy[0], kps.xy[1],
        ratio_threshold=0.7,
        max_jump_radius=mcfg.max_jump_radius,
        use_ratio_test=True,
        filter_matches=False,
        use_spatial_penalty=True,
    )
    return int(np.asarray(match.valid).sum())


def test_pyramid_capacity_and_bounds():
    frame = _load("images_test_loop2", 0)
    kps, desc = _detect(frame, levels=3)
    assert kps.xy.shape[0] == 1024  # total capacity preserved
    assert desc.shape == (1024, 32)
    v = kps.valid
    assert v.sum() > 200
    h, w = frame.shape
    assert (kps.xy[v, 0] <= w - 1 + 1e-3).all()
    assert (kps.xy[v, 1] <= h - 1 + 1e-3).all()


def test_pyramid_adds_coarse_scale_keypoints():
    """Upper levels must contribute valid keypoints of their own."""
    frame = _load("images_test_loop2", 0)
    kps1, _ = _detect(frame, levels=1)
    kps3, _ = _detect(frame, levels=3)
    # the level-0 block of the 3-level set is smaller than the full
    # single-scale set, so upper levels must fill the difference
    assert kps3.valid.sum() > 0.5 * kps1.valid.sum()
    # keypoints exist at non-integer (scaled-back) coordinates — upper levels
    frac = np.abs(kps3.xy[kps3.valid] % 1.0)
    assert (frac > 1e-6).any(), "no scaled-back (upper-level) keypoints found"


@pytest.mark.parametrize("seq,i,j,floor", [
    # images_test_loop holds 4 *widely separated* sharp views (640×480,
    # Laplacian variance 200-400): overlap, not blur, limits matching there.
    ("images_test_loop", 1, 2, 5),
    ("images_test_loop2", 0, 1, 20),
])
def test_pyramid_matching_on_loop_fixtures(seq, i, j, floor):
    """Both reference loop sequences must match with the pyramid on — and
    at least as well as single-scale (within noise) on each."""
    a, b = _load(seq, i), _load(seq, j)
    m1 = _match_count(a, b, levels=1)
    m3 = _match_count(a, b, levels=3)
    assert m3 >= floor, f"{seq}: pyramid matches too low ({m3})"
    assert m3 >= 0.75 * m1, f"{seq}: pyramid lost matches ({m3} vs {m1})"


def test_detection_on_unused_loop_fixture():
    """Every frame of the round-1-unused ``images_test_loop`` sequence must
    yield a healthy keypoint set at every pyramid level count."""
    for i in range(4):
        frame = _load("images_test_loop", i)
        for levels in (1, 3):
            kps, _ = _detect(frame, levels=levels)
            assert kps.valid.sum() > 40, (i, levels, int(kps.valid.sum()))


def test_pyramid_canvas_matches_loop(monkeypatch):
    """The stacked-canvas single-pass pyramid detect (round-5 fixed-cost
    consolidation) is BIT-IDENTICAL to the per-level loop: keypoints,
    responses, validity and descriptors."""
    cfg = DetectorConfig(
        brief_quantized_bins=16, num_levels=4, scale_factor=1.2
    )
    det = FeatureDetector(cfg)
    frames = jnp.asarray(
        np.stack([_load("images_test_loop2", 0), _load("images_test_loop2", 1)])
    )
    monkeypatch.setenv("TPUSLAM_PYRAMID_CANVAS", "1")
    kc, dc = det.detect_and_compute_batch(frames)
    monkeypatch.setenv("TPUSLAM_PYRAMID_CANVAS", "0")
    kl, dl = det.detect_and_compute_batch(frames)
    np.testing.assert_array_equal(np.asarray(kc.valid), np.asarray(kl.valid))
    np.testing.assert_array_equal(np.asarray(kc.xy), np.asarray(kl.xy))
    np.testing.assert_array_equal(
        np.asarray(kc.response), np.asarray(kl.response)
    )
    np.testing.assert_array_equal(np.asarray(kc.angle), np.asarray(kl.angle))
    np.testing.assert_array_equal(np.asarray(dc), np.asarray(dl))

