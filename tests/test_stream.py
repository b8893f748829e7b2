"""Frame decoding without OpenCV: the stdlib+NumPy PNG decoder against
cv2.imread(IMREAD_GRAYSCALE) on every fixture directory, and on frames
encoded here with each scanline filter."""

import struct
import zlib

import numpy as np
import pytest

from tpuslam.pre.png import read_png_gray
from tpuslam.pre.stream import FrameStream


@pytest.mark.parametrize(
    "seq", ["images", "images_test_loop", "images_test_loop2", "test_images"]
)
def test_png_decoder_matches_cv2(data_dir, seq):
    cv2 = pytest.importorskip("cv2")
    paths = sorted((data_dir / seq).glob("*.png"))
    assert paths
    for p in paths:
        want = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        got = read_png_gray(p)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=str(p))
    stream = FrameStream(data_dir / seq, use_native=False)
    np.testing.assert_array_equal(stream.read_frame(0)[0], read_png_gray(paths[0]))


def _encode_png(px: np.ndarray, kinds: np.ndarray) -> bytes:
    """A minimal PNG encoder: (h, w, ch) uint8, one scanline filter per row."""
    h, w, ch = px.shape
    x = px.astype(np.int32)
    pad = np.zeros((h + 1, w + 1, ch), np.int32)
    pad[1:, 1:] = x
    a, b, c = pad[1:, :-1], pad[:-1, 1:], pad[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    body = b"".join(
        bytes([k]) + ((x[y] - preds[k][y]) & 0xFF).astype(np.uint8).tobytes()
        for y, k in enumerate(kinds)
    )

    def chunk(kind: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(kind + data)
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)

    color = {1: 0, 3: 2}[ch]
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", ["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_decoder_undoes_each_scanline_filter(kitti_frames, tmp_path, filters):
    img = np.asarray(kitti_frames[0])[100:164, 300:380]
    rng = np.random.default_rng(0)
    kinds = {
        "none": np.zeros(64, int), "sub": np.ones(64, int),
        "up": np.full(64, 2), "average": np.full(64, 3), "paeth": np.full(64, 4),
        "mixed": rng.integers(0, 5, 64),
    }[filters]
    path = tmp_path / "f.png"
    path.write_bytes(_encode_png(img[..., None], kinds))
    np.testing.assert_array_equal(read_png_gray(path), img)


def test_png_decoder_rgb_gray_weights_match_cv2(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    path = tmp_path / "rgb.png"
    path.write_bytes(_encode_png(rgb, rng.integers(0, 5, 40)))
    np.testing.assert_array_equal(
        read_png_gray(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    )
