"""Camera model: intrinsics, distortion, and on-device undistortion.

Behavioural contract (reference ``include/slam/common/common.hpp:76-173``):

  * calibration is an OpenCV-YAML file with ``K<i>`` / ``D<i>`` matrices and
    an ``ImageSize: [width, height]`` entry, selected by camera index;
  * ``undistort`` maps each *output* pixel through the forward radial
    (k1, k2) + tangential (p1, p2) distortion polynomial (k3 is read but not
    used in the polynomial — the reference has the same quirk at
    ``common.hpp:151-154``), rounds to the nearest source pixel
    (half-away-from-zero like ``std::round``) and samples it;
    out-of-bounds samples become 0;
  * the undistorted image is grayscale in ``[0, 1]``.

Device-first difference: the reference rebuilds the distortion grid for every
frame (``common.hpp:143-157``); here the integer gather map is precomputed
once per camera on the host, and per-frame undistortion is a single gather
that ``jit``/``vmap`` fuse with downstream kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.config.yaml_io import load_opencv_yaml


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """std::round semantics: round half away from zero (np.round is half-even)."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


@dataclass(frozen=True)
class Camera:
    """Pinhole camera with radial-tangential distortion."""

    K: np.ndarray  # (3, 3) float64 intrinsics
    D: np.ndarray  # (n,) float64 distortion [k1, k2, p1, p2, k3]
    width: int
    height: int

    @classmethod
    def from_yaml(cls, config_path: str | Path, camera_index: int = 0) -> "Camera":
        doc = load_opencv_yaml(config_path)
        k_key = f"K{camera_index}"
        d_key = f"D{camera_index}"
        if k_key not in doc or d_key not in doc:
            raise ValueError(f"Could not find keys {k_key} or {d_key} in file.")
        K = np.asarray(doc[k_key], dtype=np.float64).reshape(3, 3)
        D = np.asarray(doc[d_key], dtype=np.float64).reshape(-1)
        size = doc.get("ImageSize", None)
        if size is None:
            raise ValueError("Could not find key ImageSize in file.")
        width, height = int(size[0]), int(size[1])
        return cls(K=K, D=D, width=width, height=height)

    # --- intrinsics accessors -------------------------------------------------
    @property
    def fx(self) -> float:
        return float(self.K[0, 0])

    @property
    def fy(self) -> float:
        return float(self.K[1, 1])

    @property
    def cx(self) -> float:
        return float(self.K[0, 2])

    @property
    def cy(self) -> float:
        return float(self.K[1, 2])

    def dist_coeff(self, i: int) -> float:
        return float(self.D[i]) if self.D.size > i else 0.0

    # --- undistortion ---------------------------------------------------------
    def undistort_map(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Precompute the inverse-sampling gather map (host, once per camera).

        Returns ``(v_src, u_src, valid)`` each of shape (H, W):
        integer source coordinates (int32) and a bool in-bounds mask.
        Mirrors the per-pixel grid math of reference ``common.hpp:143-167``.
        """
        h, w = self.height, self.width
        u = np.arange(w, dtype=np.float64)[None, :].repeat(h, axis=0)
        v = np.arange(h, dtype=np.float64)[:, None].repeat(w, axis=1)

        x = (u - self.cx) / self.fx
        y = (v - self.cy) / self.fy
        r2 = x * x + y * y
        k1, k2 = self.dist_coeff(0), self.dist_coeff(1)
        p1, p2 = self.dist_coeff(2), self.dist_coeff(3)
        # NOTE: k3 = D[4] intentionally unused, matching the reference quirk.
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        x_dist = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        y_dist = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
        u_dist = self.fx * x_dist + self.cx
        v_dist = self.fy * y_dist + self.cy

        u_src = _round_half_away(u_dist).astype(np.int64)
        v_src = _round_half_away(v_dist).astype(np.int64)
        valid = (u_src >= 0) & (u_src < w) & (v_src >= 0) & (v_src < h)
        u_src = np.clip(u_src, 0, w - 1).astype(np.int32)
        v_src = np.clip(v_src, 0, h - 1).astype(np.int32)
        return v_src, u_src, valid

    def device_undistort_map(self) -> tuple[jax.Array, jax.Array]:
        """Gather map as device arrays: flat int32 indices + validity mask."""
        v_src, u_src, valid = self.undistort_map()
        flat_idx = (v_src.astype(np.int64) * self.width + u_src).astype(np.int32)
        return jnp.asarray(flat_idx), jnp.asarray(valid)


@partial(jax.jit, static_argnames=("normalize",))
def undistort_image(
    image: jax.Array,
    flat_idx: jax.Array,
    valid: jax.Array,
    *,
    normalize: bool = True,
) -> jax.Array:
    """Undistort one grayscale image via the precomputed gather map.

    ``image``: (H, W) uint8.  Returns (H, W) float32 in [0, 1] when
    ``normalize`` (reference output contract), or uint8 in [0, 255] when not
    (the scale the feature detector consumes — equivalent because the
    reference's nearest-neighbour sampling preserves the /255 quantisation).
    """
    h, w = image.shape
    gathered = jnp.take(image.reshape(-1), flat_idx.reshape(-1), axis=0).reshape(h, w)
    gathered = jnp.where(valid, gathered, 0)
    if normalize:
        return gathered.astype(jnp.float32) / 255.0
    return gathered.astype(jnp.uint8)


@partial(jax.jit, static_argnames=("normalize",))
def undistort_batch(
    images: jax.Array,
    flat_idx: jax.Array,
    valid: jax.Array,
    *,
    normalize: bool = False,
) -> jax.Array:
    """Undistort a batch of (B, H, W) uint8 frames with one shared map."""
    return jax.vmap(lambda im: undistort_image(im, flat_idx, valid, normalize=normalize))(
        images
    )
