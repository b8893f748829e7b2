"""ctypes binding for the native C++ frame loader.

The shared library is built from ``native/frameloader.cpp`` at first use
(``make -C native``, which needs a C++ compiler and the libpng/libjpeg
headers).  Where it cannot be built, :func:`available` is False and
:class:`tpuslam.pre.stream.FrameStream` decodes in Python instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libtpuslam_frameloader.so"
_lib = None
_build_failed = False


def _build() -> bool:
    """Build the library to a private name and rename it into place, so
    that concurrent processes never load a half-written file."""
    global _build_failed
    if _build_failed:
        return False
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["make", "-s", "-C", str(_NATIVE_DIR), f"OUT={tmp}"],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        _build_failed = True
        tmp.unlink(missing_ok=True)
        return False


def _load() -> ctypes.CDLL | None:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.is_file() and not _build():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.fl_open_dir.restype = ctypes.c_void_p
    lib.fl_open_dir.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fl_decode_batch.restype = ctypes.c_int
    lib.fl_decode_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.fl_close.restype = None
    lib.fl_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeFrameLoader:
    """Threaded batch decoder over a directory of .png/.jpg frames."""

    def __init__(self, directory: str | Path):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                f"native frame loader not built (expected {_LIB_PATH}); "
                "run `make -C native`"
            )
        self._lib = lib
        n = ctypes.c_int()
        h = ctypes.c_int()
        w = ctypes.c_int()
        self._handle = lib.fl_open_dir(
            str(directory).encode(), ctypes.byref(n), ctypes.byref(h), ctypes.byref(w)
        )
        if not self._handle:
            raise RuntimeError(f"Could not open frame directory: {directory}")
        self.n_frames = n.value
        self.height = h.value
        self.width = w.value

    def decode_batch(self, start: int, count: int) -> np.ndarray:
        """Decode frames [start, start+count) → (count, H, W) uint8."""
        out = np.empty((count, self.height, self.width), dtype=np.uint8)
        rc = self._lib.fl_decode_batch(
            self._handle,
            start,
            count,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            raise RuntimeError(f"native decode failed with status {rc}")
        return out

    def decode_indices(self, indices: list[int]) -> np.ndarray:
        """Decode arbitrary frame indices (contiguous runs batched)."""
        out = np.empty((len(indices), self.height, self.width), dtype=np.uint8)
        i = 0
        while i < len(indices):
            j = i
            while j + 1 < len(indices) and indices[j + 1] == indices[j] + 1:
                j += 1
            out[i : j + 1] = self.decode_batch(indices[i], j - i + 1)
            i = j + 1
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.fl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
