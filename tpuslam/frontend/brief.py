"""Gaussian blur, intensity-centroid orientation, and steered BRIEF.

Reference semantics (``src/frontend/feature_detector.cpp:205-364``):

  * 5×5 σ=1.0 Gaussian blur before description; interior convolved, border
    rows/cols copied from the original image (``:315-364``);
  * orientation = ``atan2(m01, m10)`` in **degrees** over the disc of radius
    ``PatchSize/2``; 0 if the patch is clipped by the image border
    (``:205-231``);
  * BRIEF pattern: Gaussian pairs scaled by patch/2, pairs with any
    coordinate ≥ scale rejected **without resampling**, so the pattern may
    hold fewer than ``NumBRIEFPairs`` entries (``:286-313``);
  * per keypoint: rotate each pair by the keypoint angle (float rotate, then
    C-style truncation to int), test ``I(p1) < I(p2)``, pack LSB-first into
    bytes; pairs falling outside the image are skipped *without advancing
    the bit index* (``:233-284``); keypoints within patch/2 of the border
    get an all-zero descriptor (``:242-245``).

Accelerator-first restructuring: blur is 25 shifted multiply-adds (also
fused with FAST in ``kernels/frontend_triton.py``); orientation moments come
from full-image prefix-sum maps; BRIEF has two paths — the *exact*
continuous-angle path (per-keypoint patch lookups, reference-parity
semantics) and the *quantised* matmul path (orientation binned, all bins × all
pairs computed as one int8 matmul against a constant ±1 weight matrix, bit
packing via a precomputed compaction permutation).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.frontend.fast import KeypointSet

BLUR_KERNEL_SIZE = 5  # reference feature_detector.hpp:17
BLUR_SIGMA = 1.0


def gaussian_kernel(kernel_size: int = BLUR_KERNEL_SIZE, sigma: float = BLUR_SIGMA) -> np.ndarray:
    """Normalised Gaussian kernel, float64 on host (reference ``:322-339``)."""
    if kernel_size % 2 == 0:
        raise ValueError("Kernel size must be odd")
    half = kernel_size // 2
    ii, jj = np.meshgrid(np.arange(-half, half + 1), np.arange(-half, half + 1), indexing="ij")
    k = np.exp(-(ii * ii + jj * jj) / (2.0 * sigma * sigma))
    return k / k.sum()


@partial(jax.jit, static_argnames=("kernel_size",))
def gaussian_blur_u8(
    image: jax.Array, kernel: jax.Array, *, kernel_size: int = BLUR_KERNEL_SIZE
) -> jax.Array:
    """Blur a (H, W) uint8 image; borders copied from the original.

    Interior pixels: round-half-away(float conv), matching ``std::round``
    over the positive convolution sums (reference ``:341-355``).

    Implementation: the 2D kernel as 25 shifted multiply-adds fused by XLA
    into one elementwise pass, which keeps the exact 2D summation order
    (all-positive taps, float32); a single-channel ``lax.conv`` would
    hand XLA a convolution layout that suits no matrix unit.
    """
    half = kernel_size // 2
    img = image.astype(jnp.float32)
    h, w = image.shape
    padded = jnp.pad(img, half)
    acc = jnp.zeros_like(img)
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            shifted = jax.lax.slice(
                padded, (dy + half, dx + half), (dy + half + h, dx + half + w)
            )
            acc = acc + kernel[dy + half, dx + half] * shifted
    interior = jnp.floor(acc + 0.5).astype(jnp.uint8)
    row = jnp.arange(h)[:, None]
    col = jnp.arange(w)[None, :]
    border = (row < half) | (row >= h - half) | (col < half) | (col >= w - half)
    return jnp.where(border, image, interior)


class BriefPattern(NamedTuple):
    """Fixed sampling pattern, generated once (pytree of device arrays)."""

    p1: jax.Array  # (P, 2) int32 — first point offsets (x, y)
    p2: jax.Array  # (P, 2) int32 — second point offsets
    pair_valid: jax.Array  # (P,) bool — survived rejection sampling
    # Static compaction permutation: slot b ← pair slot_to_pair[b]
    # (the pattern-rejection "skip without advancing" as a fixed gather).
    slot_to_pair: jax.Array  # (P,) int32 (clamped; see slot_used)
    slot_used: jax.Array  # (P,) bool


def generate_brief_pattern(
    num_pairs: int, patch_size: int, seed: int = 42
) -> BriefPattern:
    """Gaussian point-pair pattern with the reference's rejection rule.

    N(0,1)·(patch/2) coordinates; a pair is kept only if all four coords
    satisfy ``|c| < scale`` — rejected pairs are dropped, not resampled
    (reference ``feature_detector.cpp:296-311``), so ``pair_valid`` marks the
    survivors.  The PRNG differs from the reference's libstdc++ engine (the
    exact stream is an implementation detail there, fixed-per-run either
    way); determinism per ``seed`` is the contract.
    """
    rng = np.random.default_rng(seed)
    scale = patch_size / 2.0
    coords = rng.normal(0.0, 1.0, size=(num_pairs, 4)) * scale
    keep = np.all(np.abs(coords) < scale, axis=1)
    ints = coords.astype(np.int32)  # C-style trunc toward zero
    p1 = np.where(keep[:, None], ints[:, 0:2], 0)
    p2 = np.where(keep[:, None], ints[:, 2:4], 0)
    ranks = np.cumsum(keep) - 1
    slot_to_pair = np.full(num_pairs, num_pairs, dtype=np.int32)
    valid_j = np.nonzero(keep)[0]
    slot_to_pair[ranks[valid_j]] = valid_j
    slot_used = slot_to_pair < num_pairs
    return BriefPattern(
        p1=jnp.asarray(p1),
        p2=jnp.asarray(p2),
        pair_valid=jnp.asarray(keep),
        slot_to_pair=jnp.asarray(np.minimum(slot_to_pair, num_pairs - 1)),
        slot_used=jnp.asarray(slot_used),
    )


def _gather_pixels(image: jax.Array, xy: jax.Array) -> jax.Array:
    """Gather image[y, x] for (..., 2) int coordinate arrays (no clipping)."""
    h, w = image.shape
    x = jnp.clip(xy[..., 0], 0, w - 1)
    y = jnp.clip(xy[..., 1], 0, h - 1)
    return image[y, x]


def _windowed_sum(cum: jax.Array, h: int, axis: int) -> jax.Array:
    """Sum of the ±h window at each position, from an exclusive prefix sum.

    ``cum`` has length n+1 along ``axis`` (leading zero); edge-padded static
    slices (not gathers) reproduce a truncated window at the borders
    (masked by callers anyway).
    """
    n = cum.shape[axis] - 1
    pad = [(0, 0)] * cum.ndim
    pad[axis] = (h, h + 1)
    padded = jnp.pad(cum, pad, mode="edge")
    hi = jax.lax.slice_in_dim(padded, 2 * h + 1, 2 * h + 1 + n, axis=axis)
    lo = jax.lax.slice_in_dim(padded, 0, n, axis=axis)
    return hi - lo


def orientation_moment_maps(
    image_f32: jax.Array, radius: int
) -> tuple[jax.Array, jax.Array]:
    """Full-image intensity-centroid moment maps (m01, m10).

    m10(y, x) = Σ_u u · Σ_{|v| ≤ h(u)} I(y+v, x+u) over the disc
    (u² + v² ≤ r²), built from prefix sums + shifted adds — O(r) passes of
    pure elementwise work instead of per-keypoint 31×31 gathers.  Values match the direct disc sum exactly
    for interior pixels; border pixels are masked by the caller (the
    reference returns angle 0 there anyway, ``feature_detector.cpp:210-214``).
    """
    img = image_f32
    # exclusive prefix sums with a leading zero
    cum_v = jnp.concatenate([jnp.zeros((1, img.shape[1]), img.dtype),
                             jnp.cumsum(img, axis=0)], axis=0)
    cum_h = jnp.concatenate([jnp.zeros((img.shape[0], 1), img.dtype),
                             jnp.cumsum(img, axis=1)], axis=1)

    # Vertical window sums per |u| half-height (shared between ±u).
    heights = {abs(u): int(np.floor(np.sqrt(radius * radius - u * u)))
               for u in range(-radius, radius + 1)}
    vert = {h: _windowed_sum(cum_v, h, axis=0) for h in set(heights.values())}
    horiz = {h: _windowed_sum(cum_h, h, axis=1) for h in set(heights.values())}

    h_img, w_img = img.shape
    m10 = jnp.zeros_like(img)
    m01 = jnp.zeros_like(img)
    vert_p = {h: jnp.pad(a, ((0, 0), (radius, radius))) for h, a in vert.items()}
    horiz_p = {h: jnp.pad(a, ((radius, radius), (0, 0))) for h, a in horiz.items()}
    for u in range(-radius, radius + 1):
        if u == 0:
            continue
        shifted = jax.lax.slice(
            vert_p[heights[abs(u)]], (0, u + radius), (h_img, u + radius + w_img)
        )
        m10 = m10 + u * shifted
    for v in range(-radius, radius + 1):
        if v == 0:
            continue
        shifted = jax.lax.slice(
            horiz_p[heights[abs(v)]], (v + radius, 0), (v + radius + h_img, w_img)
        )
        m01 = m01 + v * shifted
    return m01, m10


def compute_orientations(
    image_blurred: jax.Array, kps: KeypointSet, patch_size: int
) -> jax.Array:
    """Intensity-centroid angles (degrees) for every keypoint at once.

    Uses the blurred image (the reference computes orientation after
    blurring, ``feature_detector.cpp:33-40``); moments come from full-image
    prefix-sum maps, then one single-pixel gather per keypoint.
    """
    radius = patch_size // 2
    h, w = image_blurred.shape
    xi = kps.xy[..., 0].astype(jnp.int32)
    yi = kps.xy[..., 1].astype(jnp.int32)

    m01_map, m10_map = orientation_moment_maps(
        image_blurred.astype(jnp.float32), radius
    )
    xc = jnp.clip(xi, 0, w - 1)
    yc = jnp.clip(yi, 0, h - 1)
    m01 = m01_map[yc, xc]
    m10 = m10_map[yc, xc]

    in_bounds = (
        (xi - radius >= 0) & (xi + radius < w) & (yi - radius >= 0) & (yi + radius < h)
    )
    angle = jnp.arctan2(m01, m10) * (180.0 / jnp.pi)
    return jnp.where(in_bounds & kps.valid, angle, 0.0).astype(jnp.float32)


def patch_side(patch_size: int) -> int:
    """Rotation-patch side rounded up to the 8-sublane tile.

    The logical patch is (2·half+1)² (=45² at patch 31); extraction works in
    8-row-aligned units, so patches carry up to 7 extra rows/cols of slack
    on the bottom/right (weight matrices are zero there).
    """
    return -(-(2 * rotation_patch_half(patch_size) + 1) // 8) * 8


def padded_patch_len(patch_size: int) -> int:
    """Flattened rotation-patch length rounded up to the 128-lane tile."""
    s = patch_side(patch_size)
    return -(-(s * s) // 128) * 128


def disc_moment_weights(patch_size: int) -> np.ndarray:
    """(S2p, 2) int8 disc weights for patch-local orientation moments.

    Column 0 carries the m01 (v) weights, column 1 the m10 (u) weights, over
    the disc u² + v² ≤ (patch/2)² laid out in flattened rotation-patch
    coordinates.  Because the disc is symmetric (Σu = Σv = 0), the moments of
    −128-shifted int8 patches equal the moments of the raw intensities
    exactly — so orientation is one tiny int8 matmul over patches the
    BRIEF path extracts anyway, replacing the full-image prefix-sum moment
    maps in the hot path.
    """
    half = rotation_patch_half(patch_size)
    r = patch_size // 2
    S = patch_side(patch_size)
    W = np.zeros((padded_patch_len(patch_size), 2), dtype=np.int8)
    for v in range(-r, r + 1):
        for u in range(-r, r + 1):
            if u * u + v * v <= r * r:
                idx = (v + half) * S + (u + half)
                W[idx, 0] = v
                W[idx, 1] = u
    return W


def extract_brief_patches_i8(
    image_blurred: jax.Array, kps: KeypointSet, patch_size: int
) -> jax.Array:
    """(K, S2p) int8 flattened patches centred on each keypoint.

    The image is zero-padded by the rotation-patch half-width so patches are
    always centred; intensities are shifted by −128 into int8 (matmul input;
    the BRIEF comparison and the disc moments are shift-invariant).  The
    patch row stride is ``patch_side`` (8-aligned, matching the Pallas
    extraction kernel); rows past side² are zero padding to the lane tile.
    """
    half = rotation_patch_half(patch_size)
    S = patch_side(patch_size)
    h, w = image_blurred.shape
    padded = jnp.pad(image_blurred, ((half, S - half - 1), (half, S - half - 1)))
    xi = jnp.clip(kps.xy[..., 0].astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(kps.xy[..., 1].astype(jnp.int32), 0, h - 1)

    def one(sy_i, sx_i):
        return jax.lax.dynamic_slice(padded, (sy_i, sx_i), (S, S))

    patches = jax.vmap(one)(yi, xi)  # (K, S, S) uint8, top-left at centre−half
    flat = (patches.astype(jnp.int16) - 128).astype(jnp.int8).reshape(-1, S * S)
    return jnp.pad(flat, ((0, 0), (0, padded_patch_len(patch_size) - S * S)))


def orientations_from_patches(
    patches_i8: jax.Array,
    moment_weights: jax.Array,
    kps: KeypointSet,
    patch_size: int,
    image_shape: tuple[int, int],
) -> jax.Array:
    """Intensity-centroid angles (degrees) from pre-extracted patches.

    Integer-exact equivalent of :func:`compute_orientations` (the disc sums
    are int32, not float32 accumulations): moments are one (K, S2p) ·
    (S2p, 2) int8 matmul.  Border keypoints (disc clipped) get angle 0, the
    reference rule (``feature_detector.cpp:210-214``).
    """
    h, w = image_shape
    m = jax.lax.dot_general(
        patches_i8,
        moment_weights,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # (K, 2) — columns (m01, m10)
    m01 = m[:, 0].astype(jnp.float32)
    m10 = m[:, 1].astype(jnp.float32)
    radius = patch_size // 2
    xi = kps.xy[..., 0].astype(jnp.int32)
    yi = kps.xy[..., 1].astype(jnp.int32)
    in_bounds = (
        (xi - radius >= 0) & (xi + radius < w) & (yi - radius >= 0) & (yi + radius < h)
    )
    angle = jnp.arctan2(m01, m10) * (180.0 / jnp.pi)
    return jnp.where(in_bounds & kps.valid, angle, 0.0).astype(jnp.float32)


def quantize_angles(angles_deg: jax.Array, bins: int) -> jax.Array:
    """Angle (degrees) → orientation bin over the full circle."""
    theta = jnp.deg2rad(angles_deg)
    frac = jnp.mod(theta / (2.0 * jnp.pi), 1.0)
    return jnp.clip((frac * bins + 0.5).astype(jnp.int32) % bins, 0, bins - 1)


def build_brief_bin_weights(
    pattern: BriefPattern, patch_size: int, bins: int
) -> tuple[np.ndarray, np.ndarray]:
    """Constant ±1 weight matrix for the matmul BRIEF path.

    For each orientation bin b and pair j, the comparison
    ``I(p2) − I(p1)`` over a flattened (S, S) patch centred on the keypoint
    is a dot product with a 2-nonzero ±1 vector.  Stacking all bins × pairs
    gives W (S2p, bins·P) int8 (rows padded to the 128-lane tile), so all
    descriptors of a frame are one ``patches @ W`` int8 matmul — the tensor cores absorb the
    1000× nominal redundancy, where random gathers would be latency-bound.

    Returns (W, in_patch (bins, P) validity) — pairs whose *quantised*
    rotation stays inside the patch (always true by construction, kept for
    safety).
    """
    half = rotation_patch_half(patch_size)
    S = patch_side(patch_size)
    p1 = np.asarray(pattern.p1)
    p2 = np.asarray(pattern.p2)
    pv = np.asarray(pattern.pair_valid)
    P = p1.shape[0]
    W = np.zeros((padded_patch_len(patch_size), bins * P), dtype=np.int8)
    ok = np.zeros((bins, P), dtype=bool)
    for b in range(bins):
        a = 2.0 * np.pi * b / bins
        ca, sa = np.float32(np.cos(a)), np.float32(np.sin(a))
        # same trunc-toward-zero int cast as the exact path
        x1 = (p1[:, 0] * ca - p1[:, 1] * sa).astype(np.int32)
        y1 = (p1[:, 0] * sa + p1[:, 1] * ca).astype(np.int32)
        x2 = (p2[:, 0] * ca - p2[:, 1] * sa).astype(np.int32)
        y2 = (p2[:, 0] * sa + p2[:, 1] * ca).astype(np.int32)
        inside = (
            (np.abs(x1) <= half) & (np.abs(y1) <= half)
            & (np.abs(x2) <= half) & (np.abs(y2) <= half) & pv
        )
        ok[b] = inside
        idx1 = (y1 + half) * S + (x1 + half)
        idx2 = (y2 + half) * S + (x2 + half)
        cols = b * P + np.arange(P)
        # bit is I(p1) < I(p2) ⇔ I(p2) − I(p1) > 0
        np.add.at(W, (idx2[inside], cols[inside]), 1)
        np.add.at(W, (idx1[inside], cols[inside]), -1)
    return W, ok


def brief_bits_from_dots(
    own: jax.Array,
    bin_idx: jax.Array,
    kps: KeypointSet,
    pattern: BriefPattern,
    bins: int,
    num_pairs: int,
    patch_size: int,
    image_shape: tuple[int, int],
) -> jax.Array:
    """Own-bin comparison dots → packed descriptor bytes (quantised path).

    ``own``: (K, P) int32 ``I(p2) − I(p1)`` dots of each keypoint's own
    orientation bin.  Applies in-image validity from the quantised rotation,
    the static pattern-compaction permutation, the border rule, and LSB-first
    byte packing.  Shared epilogue of the XLA one-hot and Pallas paths.

    Bit placement: the exact path compacts positions over the per-keypoint
    validity mask ("skip without advancing") with a scatter.  Pattern-rejection validity is identical for every keypoint, so
    its compaction is one STATIC permutation; only pairs leaving the image
    (keypoints within rotation_patch_half of the border) would shift later
    bits in the reference — here they contribute a 0 at their fixed slot
    instead (documented deviation of the quantised path; the exact path
    keeps reference semantics).
    """
    h, w = image_shape
    n_bytes = num_pairs // 8
    K = kps.xy.shape[0]
    xi = kps.xy[..., 0].astype(jnp.int32)
    yi = kps.xy[..., 1].astype(jnp.int32)
    bit_val = own > 0

    # In-image validity from the *quantised* rotation (consistent with bits).
    a = bin_idx.astype(jnp.float32) * (2.0 * jnp.pi / bins)
    cos_t = jnp.cos(a)[:, None]
    sin_t = jnp.sin(a)[:, None]
    p1 = pattern.p1.astype(jnp.float32)
    p2 = pattern.p2.astype(jnp.float32)

    def rotate(p):
        x = p[None, :, 0] * cos_t - p[None, :, 1] * sin_t
        y = p[None, :, 0] * sin_t + p[None, :, 1] * cos_t
        return x.astype(jnp.int32) + xi[:, None], y.astype(jnp.int32) + yi[:, None]

    x1, y1 = rotate(p1)
    x2, y2 = rotate(p2)
    in_img = (
        (x1 >= 0) & (x1 < w) & (y1 >= 0) & (y1 < h)
        & (x2 >= 0) & (x2 < w) & (y2 >= 0) & (y2 < h)
    )
    bit_val = bit_val & in_img & pattern.pair_valid[None, :]

    bits = (
        jnp.take(bit_val, pattern.slot_to_pair, axis=1)
        & pattern.slot_used[None, :]
    )  # (K, desc_bits)

    radius = patch_size // 2
    ok = (
        (xi - radius >= 0) & (xi + radius < w) & (yi - radius >= 0)
        & (yi + radius < h) & kps.valid
    )
    bits = bits & ok[:, None]
    weights = (1 << jnp.arange(8, dtype=jnp.int32)).astype(jnp.uint8)
    return jnp.sum(
        bits.reshape(K, n_bytes, 8).astype(jnp.uint8) * weights[None, None, :],
        axis=-1,
        dtype=jnp.uint8,
    )


def quantized_brief_from_patches(
    patches_i8: jax.Array,
    kps: KeypointSet,
    angles_deg: jax.Array,
    pattern: BriefPattern,
    bin_weights: jax.Array,
    num_pairs: int,
    patch_size: int,
    bins: int,
    image_shape: tuple[int, int],
) -> jax.Array:
    """Quantised steered BRIEF from pre-extracted (K, S2p) int8 patches.

    All bins × all pairs are one (K, S2p)·(S2p, bins·P) int8 product with
    int32 accumulation; a one-hot masked reduction then keeps each
    keypoint's own bin in one fused read of the dot tensor.
    """
    K = patches_i8.shape[0]
    P = pattern.p1.shape[0]
    bin_idx = quantize_angles(angles_deg, bins)
    dots = jax.lax.dot_general(
        patches_i8,
        bin_weights,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # (K, bins*P)
    onehot = jax.nn.one_hot(bin_idx, bins, dtype=jnp.int32)
    own = jnp.sum(dots.reshape(K, bins, P) * onehot[:, :, None], axis=1)  # (K, P)
    return brief_bits_from_dots(
        own, bin_idx, kps, pattern, bins, num_pairs, patch_size, image_shape
    )


def compute_brief_descriptors_quantized(
    image_blurred: jax.Array,
    kps: KeypointSet,
    angles_deg: jax.Array,
    pattern: BriefPattern,
    bin_weights: jax.Array,
    num_pairs: int,
    patch_size: int,
    bins: int,
) -> jax.Array:
    """Steered BRIEF with orientation quantised to ``bins``.

    Behaviourally equivalent to :func:`compute_brief_descriptors` up to the
    angle quantisation (≤ 180/bins degrees); the exact continuous-angle
    path remains the parity/golden-test reference.
    """
    patches = extract_brief_patches_i8(image_blurred, kps, patch_size)
    return quantized_brief_from_patches(
        patches, kps, angles_deg, pattern, bin_weights, num_pairs, patch_size,
        bins, image_blurred.shape,
    )


def rotation_patch_half(patch_size: int) -> int:
    """Half-size of a patch guaranteed to contain all rotated BRIEF points.

    Pattern coords satisfy |c| < patch/2, so rotated magnitudes stay below
    (patch/2)·√2."""
    return int(np.ceil((patch_size / 2.0) * np.sqrt(2.0)))


def extract_patches(
    image: jax.Array, kps: KeypointSet, half: int
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """(K, S, S) patches centred (modulo border clamping) on each keypoint.

    Returns (patches, start_y (K,), start_x (K,)).  Starts are clamped so
    the patch always lies inside the image; the clamped window still covers
    every in-image point within ±half of the keypoint."""
    S = 2 * half + 1
    h, w = image.shape
    xi = kps.xy[..., 0].astype(jnp.int32)
    yi = kps.xy[..., 1].astype(jnp.int32)
    sy = jnp.clip(yi - half, 0, h - S)
    sx = jnp.clip(xi - half, 0, w - S)

    def one(sy_i, sx_i):
        return jax.lax.dynamic_slice(image, (sy_i, sx_i), (S, S))

    return jax.vmap(one)(sy, sx), sy, sx


def compute_brief_descriptors(
    image_blurred: jax.Array,
    kps: KeypointSet,
    angles_deg: jax.Array,
    pattern: BriefPattern,
    num_pairs: int,
    patch_size: int,
) -> jax.Array:
    """Steered BRIEF for all keypoints: (K, num_pairs/8) uint8.

    Vectorised equivalent of reference ``feature_detector.cpp:233-284``
    including the skip-without-advancing bit compaction.
    """
    h, w = image_blurred.shape
    desc_bits = num_pairs  # descriptorSize * 8
    n_bytes = num_pairs // 8

    theta = angles_deg * (jnp.pi / 180.0)
    cos_t = jnp.cos(theta)[:, None]  # (K, 1)
    sin_t = jnp.sin(theta)[:, None]

    p1 = pattern.p1.astype(jnp.float32)  # (P, 2)
    p2 = pattern.p2.astype(jnp.float32)

    def rotate(p):
        x = p[None, :, 0] * cos_t - p[None, :, 1] * sin_t  # (K, P)
        y = p[None, :, 0] * sin_t + p[None, :, 1] * cos_t
        # C-style int cast truncates toward zero.
        return x.astype(jnp.int32), y.astype(jnp.int32)

    x1, y1 = rotate(p1)
    x2, y2 = rotate(p2)
    xi = kps.xy[..., 0].astype(jnp.int32)[:, None]
    yi = kps.xy[..., 1].astype(jnp.int32)[:, None]
    x1, y1, x2, y2 = x1 + xi, y1 + yi, x2 + xi, y2 + yi

    in_img = (
        (x1 >= 0) & (x1 < w) & (y1 >= 0) & (y1 < h)
        & (x2 >= 0) & (x2 < w) & (y2 >= 0) & (y2 < h)
    )
    valid_pair = in_img & pattern.pair_valid[None, :]  # (K, P)

    # Pixel lookups through per-keypoint patches: one contiguous
    # dynamic-slice per keypoint, then small-range take_along_axis — in
    # place of 2·K·P scattered global gathers.
    half = rotation_patch_half(patch_size)
    S = 2 * half + 1
    if S <= min(h, w):
        patches, sy, sx = extract_patches(image_blurred, kps, half)
        flat = patches.reshape(patches.shape[0], S * S)

        def lookup(xg, yg):
            lx = jnp.clip(xg - sx[:, None], 0, S - 1)
            ly = jnp.clip(yg - sy[:, None], 0, S - 1)
            return jnp.take_along_axis(flat, ly * S + lx, axis=1)

        i1 = lookup(x1, y1)
        i2 = lookup(x2, y2)
    else:  # image smaller than the rotation patch (tiny test frames)
        i1 = _gather_pixels(image_blurred, jnp.stack([x1, y1], axis=-1))
        i2 = _gather_pixels(image_blurred, jnp.stack([x2, y2], axis=-1))
    bit_val = (i1 < i2) & valid_pair  # (K, P)

    # Skip-without-advancing: bit position = exclusive cumsum of validity.
    pos = jnp.cumsum(valid_pair.astype(jnp.int32), axis=1) - 1  # (K, P)
    in_range = valid_pair & (pos < desc_bits)

    # Scatter bits to their compacted positions (out-of-range → dropped).
    # Positions are unique per keypoint (cumsum of a 0/1 mask), so a
    # scatter-max is exact; far cheaper than a (K, P, bits) one-hot.
    pos_safe = jnp.where(in_range, pos, desc_bits)  # desc_bits → dropped
    bits = (
        jnp.zeros((bit_val.shape[0], desc_bits), dtype=jnp.uint8)
        .at[jnp.arange(bit_val.shape[0])[:, None], pos_safe]
        .max(bit_val.astype(jnp.uint8), mode="drop")
        .astype(bool)
    )

    # Border rule: all-zero descriptor near the border (patch/2 margin).
    radius = patch_size // 2
    xk = kps.xy[..., 0].astype(jnp.int32)
    yk = kps.xy[..., 1].astype(jnp.int32)
    ok = (
        (xk - radius >= 0) & (xk + radius < w) & (yk - radius >= 0) & (yk + radius < h)
        & kps.valid
    )
    bits = bits & ok[:, None]

    # Pack LSB-first into bytes.
    weights = (1 << jnp.arange(8, dtype=jnp.int32)).astype(jnp.uint8)
    packed = jnp.sum(
        bits.reshape(bits.shape[0], n_bytes, 8).astype(jnp.uint8) * weights[None, None, :],
        axis=-1,
        dtype=jnp.uint8,
    )
    return packed
