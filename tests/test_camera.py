"""Camera + undistortion tests.

The golden oracle is an independent NumPy implementation of the reference's
per-pixel inverse-distortion sampling (common.hpp:127-173), checked against
the precomputed-gather device path.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from tpuslam.common.camera import Camera, undistort_batch, undistort_image

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


@pytest.fixture(scope="module")
def camera():
    return Camera.from_yaml(CONFIGS / "camera.yml", camera_index=0)


def numpy_undistort_oracle(cam: Camera, image: np.ndarray) -> np.ndarray:
    """Direct per-pixel reimplementation of the reference formula (float64)."""
    h, w = cam.height, cam.width
    img = image.astype(np.float64) / 255.0
    out = np.zeros((h, w), dtype=np.float64)
    k1, k2 = cam.dist_coeff(0), cam.dist_coeff(1)
    p1, p2 = cam.dist_coeff(2), cam.dist_coeff(3)
    for i in range(h):
        y = (i - cam.cy) / cam.fy
        for j in range(w):
            x = (j - cam.cx) / cam.fx
            r2 = x * x + y * y
            radial = 1 + k1 * r2 + k2 * r2 * r2
            xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            yd = y * radial + 2 * p2 * x * y + p1 * (r2 + 2 * y * y)
            u = int(np.floor(cam.fx * xd + cam.cx + 0.5))
            v = int(np.floor(cam.fy * yd + cam.cy + 0.5))
            if 0 <= u < w and 0 <= v < h:
                out[i, j] = img[v, u]
    return out


def test_camera_loading(camera):
    assert camera.width == 1392
    assert camera.height == 512
    assert camera.fx == pytest.approx(984.2439)
    assert camera.fy == pytest.approx(980.8141)
    assert camera.cx == pytest.approx(690.0)
    assert camera.cy == pytest.approx(233.1966)
    assert camera.dist_coeff(0) == pytest.approx(-0.3728755)


def test_camera_missing_key(tmp_path):
    p = tmp_path / "bad.yml"
    p.write_text("%YAML:1.0\n---\nImageSize: [10, 10]\n")
    with pytest.raises(ValueError, match="K0 or D0"):
        Camera.from_yaml(p)


def test_undistort_matches_oracle(camera, kitti_frames):
    # Full-resolution oracle is O(HW) python — run on a cropped camera to stay fast.
    img = kitti_frames[0]
    assert img.shape == (camera.height, camera.width)

    flat_idx, valid = camera.device_undistort_map()
    got = np.asarray(undistort_image(jnp.asarray(img), flat_idx, valid, normalize=True))

    # Subsample the oracle to 64x64 pixel positions to keep the test quick.
    h, w = img.shape
    oracle = numpy_undistort_oracle_sub(camera, img, stride_y=h // 64, stride_x=w // 64)
    sub = got[:: h // 64, :: w // 64][: oracle.shape[0], : oracle.shape[1]]
    np.testing.assert_allclose(sub, oracle, atol=1e-6)


def numpy_undistort_oracle_sub(cam, image, stride_y, stride_x):
    h, w = cam.height, cam.width
    img = image.astype(np.float64) / 255.0
    k1, k2 = cam.dist_coeff(0), cam.dist_coeff(1)
    p1, p2 = cam.dist_coeff(2), cam.dist_coeff(3)
    rows = range(0, h, stride_y)
    cols = range(0, w, stride_x)
    out = np.zeros((len(rows), len(cols)), dtype=np.float64)
    for oi, i in enumerate(rows):
        y = (i - cam.cy) / cam.fy
        for oj, j in enumerate(cols):
            x = (j - cam.cx) / cam.fx
            r2 = x * x + y * y
            radial = 1 + k1 * r2 + k2 * r2 * r2
            xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            yd = y * radial + 2 * p2 * x * y + p1 * (r2 + 2 * y * y)
            u = int(np.floor(cam.fx * xd + cam.cx + 0.5))
            v = int(np.floor(cam.fy * yd + cam.cy + 0.5))
            if 0 <= u < w and 0 <= v < h:
                out[oi, oj] = img[v, u]
    return out


def test_undistort_batch_uint8(camera, kitti_frames):
    imgs = jnp.stack([jnp.asarray(f) for f in kitti_frames[:3]])
    flat_idx, valid = camera.device_undistort_map()
    out = undistort_batch(imgs, flat_idx, valid, normalize=False)
    assert out.shape == imgs.shape
    assert out.dtype == jnp.uint8
    # uint8 output must equal 255 * the normalized output, exactly.
    one = undistort_image(imgs[0], flat_idx, valid, normalize=True)
    np.testing.assert_array_equal(
        np.asarray(out[0]), np.asarray(jnp.round(one * 255).astype(jnp.uint8))
    )


def test_undistort_identity_when_no_distortion(camera, kitti_frames):
    cam0 = Camera(K=camera.K, D=np.zeros(5), width=camera.width, height=camera.height)
    flat_idx, valid = cam0.device_undistort_map()
    img = jnp.asarray(kitti_frames[0])
    out = undistort_image(img, flat_idx, valid, normalize=False)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(img))
