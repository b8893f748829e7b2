"""Native C++ frame loader tests (skipped where the library cannot be built)."""

import numpy as np
import pytest

from tpuslam.pre import native_loader


@pytest.fixture(autouse=True)
def _built():
    if not native_loader.available():
        pytest.skip("native loader cannot be built here (make -C native)")


@pytest.fixture(scope="module")
def loader(data_dir):
    return native_loader.NativeFrameLoader(data_dir / "images")


def test_open(loader):
    assert loader.n_frames == 10
    assert (loader.height, loader.width) == (512, 1392)


def test_decode_matches_cv2(loader, kitti_frames):
    batch = loader.decode_batch(0, 10)
    for i in range(10):
        np.testing.assert_array_equal(batch[i], kitti_frames[i])


def test_decode_indices_with_gaps(loader, kitti_frames):
    out = loader.decode_indices([0, 1, 2, 5, 8, 9])
    np.testing.assert_array_equal(out[0], kitti_frames[0])
    np.testing.assert_array_equal(out[3], kitti_frames[5])
    np.testing.assert_array_equal(out[5], kitti_frames[9])


def test_decode_color_png(data_dir):
    """images_test_loop2 frames may be color; conversion must match cv2."""
    import cv2

    loader = native_loader.NativeFrameLoader(data_dir / "images_test_loop2")
    batch = loader.decode_batch(0, loader.n_frames)
    for i, p in enumerate(sorted((data_dir / "images_test_loop2").glob("*.png"))):
        want = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        diff = np.abs(batch[i].astype(int) - want.astype(int))
        # cv2 IMREAD_GRAYSCALE converts RGBA sources through a different
        # rounding path than the fixed-point BGR→GRAY coefficients; all
        # differences must stay within 1 intensity level.
        assert diff.max() <= 1


def test_out_of_range(loader):
    with pytest.raises(RuntimeError):
        loader.decode_batch(8, 5)


def test_bad_directory(tmp_path):
    with pytest.raises(RuntimeError, match="Could not open"):
        native_loader.NativeFrameLoader(tmp_path)
