"""FAST corner detection as a fully-vectorized XLA stencil.

Reference semantics (``src/frontend/feature_detector.cpp:56-203``):

  * 16-pixel Bresenham circle of radius 3 around each candidate
    (offset table ``feature_detector.hpp:138-153``);
  * a pixel is *brighter* if ``I(n) > I(c) + T`` and *darker* if
    ``I(n) < I(c) - T``;
  * cardinal pretest on circle positions {0, 8} then {4, 12}
    (``feature_detector.cpp:78-112``): at least one of {0, 8} classified, and
    at least 3 of the 4 cardinals brighter or at least 3 darker;
  * full segment test: a *circular* run of ≥ ``ContiguousPixelsThreshold``
    consecutive brighter (or darker) circle pixels
    (``feature_detector.cpp:118-142`` runs 32 wrap-around iterations);
  * score = SAD of the 16 circle intensities vs the center
    (``feature_detector.cpp:190-203``);
  * non-max suppression, then keypoints.

Accelerator-first restructuring: instead of a per-pixel scalar loop, the 16
neighbour planes are materialised with ``jnp.roll`` and every test becomes a
(16, H, W) boolean tensor op; the circular-run test is an AND-reduction over
rotated masks.  Greedy sorted NMS (inherently sequential, O(N²),
``feature_detector.cpp:147-188``) is replaced by windowed local-max NMS with
a deterministic (score desc, raster-index asc) tiebreak packed into a uint32
key for one ``reduce_window``; keypoint sets differ slightly from greedy but
trajectory-level parity is the arbiter (SURVEY §7).  Keypoints exit as a
fixed-capacity (MAX_KEYPOINTS) buffer + validity mask via ``top_k``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Bresenham circle offsets as (dx, dy), index 0 at 12 o'clock, clockwise —
# the same table as reference feature_detector.hpp:138-153.
CIRCLE_OFFSETS: tuple[tuple[int, int], ...] = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
BORDER = 3
_SCORE_BITS = 12  # max SAD = 16*255 = 4080 < 2^12
_IDX_BITS = 32 - _SCORE_BITS


class KeypointSet(NamedTuple):
    """Fixed-capacity keypoint buffer (a pytree; every field shape (..., K))."""

    xy: jax.Array  # (..., K, 2) float32 — (x, y) pixel coordinates
    response: jax.Array  # (..., K) float32 — FAST SAD score
    angle: jax.Array  # (..., K) float32 — orientation in degrees
    valid: jax.Array  # (..., K) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32), axis=-1)


def _neighbor_planes(image_i32: jax.Array) -> jax.Array:
    """(16, H, W) tensor of circle-neighbour intensities via rolls.

    Rolled wrap-around values only ever land inside the 3-pixel border, which
    is masked out downstream, so wrapping is harmless.
    """
    planes = [
        jnp.roll(image_i32, shift=(-dy, -dx), axis=(0, 1)) for (dx, dy) in CIRCLE_OFFSETS
    ]
    return jnp.stack(planes, axis=0)


def mask_run(mask: jax.Array, run: int) -> jax.Array:
    """AND of ``run`` consecutive circle entries starting at each position."""
    acc = mask
    length = 1
    while length * 2 <= run:
        acc = jnp.logical_and(acc, jnp.roll(acc, -length, axis=0))
        length *= 2
    while length < run:
        acc = jnp.logical_and(acc, jnp.roll(mask, -length, axis=0))
        length += 1
    return acc


def fast_response_and_mask(
    image: jax.Array, threshold: int, contiguous: int
) -> tuple[jax.Array, jax.Array]:
    """Compute the (H, W) corner mask and SAD score map.

    ``image``: (H, W) integer-valued (uint8 or int); returns
    ``(corner_mask bool, score int32)``, both zero in the border-3 frame.
    """
    img = image.astype(jnp.int32)
    h, w = img.shape
    center = img[None]
    neighbors = _neighbor_planes(img)

    brighter = neighbors > center + threshold  # (16, H, W)
    darker = neighbors < center - threshold

    # Cardinal pretest, exactly as the reference two-stage check.
    card = (0, 8, 4, 12)
    nb = sum(brighter[c].astype(jnp.int32) for c in card)
    nd = sum(darker[c].astype(jnp.int32) for c in card)
    first_pair = brighter[0] | darker[0] | brighter[8] | darker[8]
    pretest = first_pair & ((nb >= 3) | (nd >= 3))

    segment = jnp.any(mask_run(brighter, contiguous), axis=0) | jnp.any(
        mask_run(darker, contiguous), axis=0
    )

    row = jnp.arange(h)[:, None]
    col = jnp.arange(w)[None, :]
    in_border = (row >= BORDER) & (row < h - BORDER) & (col >= BORDER) & (col < w - BORDER)

    corner = pretest & segment & in_border
    # Rolled neighbours wrap around inside the border; the score is only
    # read at corners, and is defined as 0 there.
    score = jnp.where(in_border, jnp.sum(jnp.abs(neighbors - center), axis=0), 0)
    return corner, score


def _packed_key(score: jax.Array, mask: jax.Array) -> jax.Array:
    """uint32 key = score (12 bits) << 20 | inverted-raster-index (20 bits).

    Larger key ⇔ (higher score, then smaller raster index); zero where masked.
    For images over 2^20 pixels the raster index is right-shifted, coarsening
    (not breaking) the deterministic tiebreak.
    """
    h, w = score.shape
    idx = jnp.arange(h * w, dtype=jnp.uint32).reshape(h, w)
    n = h * w
    shift = 0
    while (n >> shift) > (1 << _IDX_BITS) - 1:
        shift += 1
    inv_idx = ((jnp.uint32(n - 1) - idx) >> shift).astype(jnp.uint32)
    key = (score.astype(jnp.uint32) << _IDX_BITS) | inv_idx
    return jnp.where(mask, key, jnp.uint32(0))


def local_max_nms(corner: jax.Array, score: jax.Array, window: int) -> jax.Array:
    """Windowed local-max NMS with deterministic tiebreak.

    A corner survives iff its packed (score, -raster) key is the maximum over
    the (2·window-1)² neighbourhood — the Chebyshev-ball superset of the
    reference's Euclidean suppression radius (< window px).
    """
    key = _packed_key(score, corner)
    half = max(window - 1, 0)
    # The square-window max is separable: two 1-D passes do (2w-1)+(2w-1)
    # comparisons per pixel instead of (2w-1)².
    pooled = jax.lax.reduce_window(
        key,
        jnp.uint32(0),
        jax.lax.max,
        window_dimensions=(2 * half + 1, 1),
        window_strides=(1, 1),
        padding="SAME",
    )
    pooled = jax.lax.reduce_window(
        pooled,
        jnp.uint32(0),
        jax.lax.max,
        window_dimensions=(1, 2 * half + 1),
        window_strides=(1, 1),
        padding="SAME",
    )
    return corner & (key == pooled) & (key > 0)


def select_keypoints(
    corner: jax.Array,
    score: jax.Array,
    *,
    nms: bool = True,
    window: int = 12,
    max_keypoints: int = 1024,
) -> KeypointSet:
    """NMS + top-k extraction from a corner mask and score map.

    When NMS is on, the top-k runs over per-tile maxima instead of every
    pixel — *exactly*, not approximately: two NMS survivors within Chebyshev
    distance ``window − 1`` would suppress each other (keys are unique), so
    each ``window``-sized tile holds at most one survivor, and that
    survivor's key is its tile max (every tile cell is within its
    suppression radius).  This shrinks the top-k from H·W candidates to
    ⌈H/window⌉·⌈W/window⌉ (~143× fewer at 1392×512/12) with bit-identical
    results; positions are recovered from the packed raster index.
    """
    if nms:
        keep = local_max_nms(corner, score, window)
    else:
        keep = corner
    h, w = corner.shape
    n = h * w
    key = _packed_key(score, keep)
    tile = window
    n_tiles = -(-h // tile) * (-(-w // tile))
    # Exact index recovery out of the packed key needs an unshifted index:
    # _packed_key starts shifting at n ≥ 2^20 (its guard is on n, not n−1),
    # so the strict bound keeps this path off for exactly-2^20-pixel images;
    # tiny images fall back to the flat path.
    if nms and tile >= 2 and n < (1 << _IDX_BITS) and n_tiles >= max_keypoints:
        pooled = jax.lax.reduce_window(
            key, jnp.uint32(0), jax.lax.max,
            window_dimensions=(tile, 1), window_strides=(tile, 1),
            padding=(((0, (-h) % tile), (0, 0))),
        )
        pooled = jax.lax.reduce_window(
            pooled, jnp.uint32(0), jax.lax.max,
            window_dimensions=(1, tile), window_strides=(1, tile),
            padding=(((0, 0), (0, (-w) % tile))),
        )
        top_keys, _ = jax.lax.top_k(pooled.reshape(-1), max_keypoints)
        inv_idx = top_keys & jnp.uint32((1 << _IDX_BITS) - 1)
        top_idx = (jnp.uint32(n - 1) - inv_idx).astype(jnp.int32)
    else:
        top_keys, top_idx = jax.lax.top_k(key.reshape(-1), max_keypoints)
    valid = top_keys > 0
    y = (top_idx // w).astype(jnp.float32)
    x = (top_idx % w).astype(jnp.float32)
    resp = (top_keys >> _IDX_BITS).astype(jnp.float32)
    return KeypointSet(
        xy=jnp.where(valid[:, None], jnp.stack([x, y], axis=-1), 0.0),
        response=jnp.where(valid, resp, 0.0),
        angle=jnp.zeros(max_keypoints, dtype=jnp.float32),
        valid=valid,
    )


def select_from_key(
    key: jax.Array, *, window: int, max_keypoints: int
) -> KeypointSet:
    """Top-k keypoints from a post-NMS packed-key plane.

    ``key``: (H, W) uint32 — ``_packed_key(score, keep)`` with NMS and
    border rules already applied (the fused Pallas kernel emits exactly
    this, ``kernels.frontend_pallas.fused_frontend_nms_batch``).  Same
    tile-pooled exact top-k as :func:`select_keypoints`; callers must
    ensure ``H·W < 2^20`` (unshifted index recovery) and
    ``n_tiles ≥ max_keypoints``.
    """
    h, w = key.shape
    n = h * w
    tile = window
    pooled = jax.lax.reduce_window(
        key, jnp.uint32(0), jax.lax.max,
        window_dimensions=(tile, 1), window_strides=(tile, 1),
        padding=(((0, (-h) % tile), (0, 0))),
    )
    pooled = jax.lax.reduce_window(
        pooled, jnp.uint32(0), jax.lax.max,
        window_dimensions=(1, tile), window_strides=(1, tile),
        padding=(((0, 0), (0, (-w) % tile))),
    )
    top_keys, _ = jax.lax.top_k(pooled.reshape(-1), max_keypoints)
    inv_idx = top_keys & jnp.uint32((1 << _IDX_BITS) - 1)
    top_idx = (jnp.uint32(n - 1) - inv_idx).astype(jnp.int32)
    valid = top_keys > 0
    y = (top_idx // w).astype(jnp.float32)
    x = (top_idx % w).astype(jnp.float32)
    resp = (top_keys >> _IDX_BITS).astype(jnp.float32)
    return KeypointSet(
        xy=jnp.where(valid[:, None], jnp.stack([x, y], axis=-1), 0.0),
        response=jnp.where(valid, resp, 0.0),
        angle=jnp.zeros(max_keypoints, dtype=jnp.float32),
        valid=valid,
    )


@partial(jax.jit, static_argnames=("threshold", "contiguous", "nms", "window", "max_keypoints"))
def detect_keypoints(
    image: jax.Array,
    *,
    threshold: int,
    contiguous: int,
    nms: bool = True,
    window: int = 12,
    max_keypoints: int = 1024,
) -> KeypointSet:
    """Full FAST detection → fixed-capacity KeypointSet (score-sorted)."""
    corner, score = fast_response_and_mask(image, threshold, contiguous)
    return select_keypoints(
        corner, score, nms=nms, window=window, max_keypoints=max_keypoints
    )
