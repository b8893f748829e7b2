"""PNG → grayscale uint8 decoding with the standard library and NumPy.

Reads non-interlaced 8-bit PNGs of every colour type (gray, gray+alpha,
RGB, RGBA, palette).  Colour is converted to gray with the weights and
truncation libpng applies for ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``
(``png_set_rgb_to_gray`` at 0.299/0.587, fixed point over 2^15); alpha is
dropped, as OpenCV does.

Scanline filters None and Sub are undone for all rows at once and Up row by
row; images with Average or Paeth rows are undone along anti-diagonals,
where every pixel's left, upper and upper-left neighbours are already
known, so each step is one vectorised NumPy update (h + w − 1 steps, far
slower than the other filters).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# libpng's rgb_to_gray coefficients for (0.299, 0.587): red and green
# truncated to 15 bits, blue the remainder.
_GRAY_WEIGHTS = (9797, 19234, 32768 - 9797 - 19234)


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        yield kind, data[pos + 8 : pos + 8 + length]
        pos += 12 + length


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, ch: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` (h rows of 1 + w·ch bytes)."""
    rows = raw.reshape(h, 1 + w * ch)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError("corrupt PNG: unknown scanline filter")
    if (kinds <= 2).all():
        # uint8 sums wrap modulo 256 as PNG's do.  None and Sub rows stand
        # alone and are undone at once; only Up rows wait for the row above.
        data = rows[:, 1:].reshape(h, w, ch)
        out = np.where(
            (kinds == 1)[:, None, None], np.cumsum(data, axis=1, dtype=np.uint8), data
        )
        for y in np.flatnonzero(kinds == 2):
            out[y] = data[y] + out[y - 1] if y else data[y]
        return out
    data = rows[:, 1:].reshape(h, w, ch).astype(np.int32)
    # Anti-diagonal sweep: x[y, i] needs x[y, i-1], x[y-1, i], x[y-1, i-1].
    x = np.zeros((h + 1, w + 1, ch), np.int32)  # zero row/col = PNG's "none"
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        i = d - y
        a, b, c = x[y + 1, i], x[y, i + 1], x[y, i]
        kind = kinds[y][:, None]
        pred = np.select(
            [kind == 1, kind == 2, kind == 3, kind == 4],
            [a, b, (a + b) >> 1, _paeth(a, b, c)],
            0,
        )
        x[y + 1, i + 1] = (data[y, i] + pred) & 0xFF
    return x[1:, 1:].astype(np.uint8)


def read_png_gray(path: str | Path) -> np.ndarray:
    """Decode a PNG file to a (H, W) uint8 grayscale array."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"not a PNG file: {path}")
    header = palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"PNG without IHDR: {path}")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace or color not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {color}, "
            f"interlace {interlace}): {path}"
        )
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w, ch)
    if color == 3:
        if palette is None:
            raise ValueError(f"palette PNG without PLTE: {path}")
        px = palette[px[..., 0]]
    elif color in (0, 4):
        return np.ascontiguousarray(px[..., 0])
    rgb = px[..., :3].astype(np.int32)
    wr, wg, wb = _GRAY_WEIGHTS
    gray = (rgb[..., 0] * wr + rgb[..., 1] * wg + rgb[..., 2] * wb) >> 15
    return gray.astype(np.uint8)
