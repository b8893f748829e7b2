"""Fused image-frontend kernel for NVIDIA GPUs: 5×5 blur + FAST corner/score.

One pass over each frame produces everything the per-pixel frontend needs:
the blurred image (for orientation and BRIEF), the FAST corner mask and the
SAD score.  The plain XLA path (``frontend.fast.fast_response_and_mask`` and
``frontend.brief.gaussian_blur_u8``) builds a (16, H, W) int32 neighbour
stack and rolled copies of it; this kernel reads the u8 frame and writes
u8 blur, u8 corner and i32 score, about 7 bytes per pixel.

Written for Pallas' Triton route.  Each program owns one (TILE_H, TILE_W)
tile of one frame:

* the 25 blur taps and 16 circle taps are masked, shifted loads straight
  from the unpadded u8 frame in global memory; neighbouring tiles re-read
  each other's halo through L1/L2, and no padded copy is made;
* the FAST segment test keeps one 16-bit "brighter" and one "darker"
  circle bitmask per pixel in registers; a circular run of ``contiguous``
  set bits is found with a few shift-and-ANDs on the bitmask doubled to 32
  bits, which is the reference's 32-iteration wrap-around run counter
  (``feature_detector.cpp:118-142``) without keeping 16 neighbour planes
  live;
* the reference border rules are applied in the kernel: blur copies the
  source in the 2-pixel frame, corners and scores are zero in the 3-pixel
  frame.

Semantics match the plain path bit for bit on integer outputs.  The blur
is a float32 sum of 25 products rounded half up; a GPU may contract a
product and a sum into one FMA, which can move a ``.5`` tie by one gray
level on a few pixels.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from tpuslam.frontend.brief import gaussian_kernel
from tpuslam.frontend.fast import BORDER, CIRCLE_OFFSETS

TILE_H = 16
TILE_W = 64
NUM_WARPS = 4
BLUR_HALF = 2


def _run_of(bits: jax.Array, run: int) -> jax.Array:
    """Whether the 16-bit circle mask ``bits`` holds ``run`` consecutive set
    bits, counted circularly (int32 in, bool out)."""
    doubled = bits | (bits << 16)
    acc = doubled
    length = 1
    while 2 * length <= run:
        acc = acc & (acc >> length)
        length *= 2
    if length < run:
        # two overlapping windows of ``length`` cover ``run`` positions
        acc = acc & (acc >> (run - length))
    # bit s of acc (s < 16) reads bits s .. s+run-1 ≤ 30: never the sign bit
    return (acc & 0xFFFF) != 0


def _frontend_kernel(
    img_ref,  # (B·H·W,) uint8, the frames flattened
    blur_ref,  # (B·H·W,) uint8 out
    corner_ref,  # (B·H·W,) uint8 out
    score_ref,  # (B·H·W,) int32 out
    *,
    h: int,
    w: int,
    threshold: int,
    contiguous: int,
    taps: tuple,
):
    b = pl.program_id(0)
    rows = pl.program_id(1) * TILE_H + jax.lax.broadcasted_iota(
        jnp.int32, (TILE_H, 1), 0
    )
    cols = pl.program_id(2) * TILE_W + jax.lax.broadcasted_iota(
        jnp.int32, (1, TILE_W), 1
    )
    base = b * (h * w)
    offsets = base + rows * w + cols  # (TILE_H, TILE_W)

    cache: dict[tuple[int, int], jax.Array] = {}

    def pixel(dy: int, dx: int) -> jax.Array:
        """int32 I(y+dy, x+dx) over the tile, 0 outside the frame."""
        if (dy, dx) not in cache:
            ok = ((rows + dy >= 0) & (rows + dy < h)) & (
                (cols + dx >= 0) & (cols + dx < w)
            )
            val = plt.load(
                img_ref.at[offsets + (dy * w + dx)], mask=ok, other=0
            )
            cache[(dy, dx)] = val.astype(jnp.int32)
        return cache[(dy, dx)]

    center = pixel(0, 0)

    # --- 5×5 Gaussian blur: the plain path's order of float32 adds --------
    acc = jnp.zeros(center.shape, jnp.float32)
    for dy, dx, k in taps:
        acc = acc + k * pixel(dy, dx).astype(jnp.float32)
    interior = jnp.floor(acc + 0.5).astype(jnp.int32)
    blur_edge = (
        (rows < BLUR_HALF) | (rows >= h - BLUR_HALF)
        | (cols < BLUR_HALF) | (cols >= w - BLUR_HALF)
    )
    blurred = jnp.where(blur_edge, center, interior)

    # --- FAST: circle bitmasks, cardinal pretest, segment test, SAD -------
    lo = center - threshold
    hi = center + threshold
    bright = jnp.zeros(center.shape, jnp.int32)
    dark = jnp.zeros(center.shape, jnp.int32)
    score = jnp.zeros(center.shape, jnp.int32)
    for i, (dx, dy) in enumerate(CIRCLE_OFFSETS):
        nb = pixel(dy, dx)
        bright = bright | ((nb > hi).astype(jnp.int32) << i)
        dark = dark | ((nb < lo).astype(jnp.int32) << i)
        score = score + jnp.abs(nb - center)

    def cardinals(bits):
        return (
            (bits & 1) + ((bits >> 4) & 1) + ((bits >> 8) & 1) + ((bits >> 12) & 1)
        )

    first_pair = ((bright | dark) & 0x101) != 0  # circle positions 0 and 8
    pretest = first_pair & ((cardinals(bright) >= 3) | (cardinals(dark) >= 3))
    segment = _run_of(bright, contiguous) | _run_of(dark, contiguous)
    in_frame = (
        (rows >= BORDER) & (rows < h - BORDER)
        & (cols >= BORDER) & (cols < w - BORDER)
    )
    corner = pretest & segment & in_frame

    inside = (rows < h) & (cols < w)
    plt.store(blur_ref.at[offsets], blurred.astype(jnp.uint8), mask=inside)
    plt.store(corner_ref.at[offsets], corner.astype(jnp.uint8), mask=inside)
    plt.store(
        score_ref.at[offsets], jnp.where(in_frame, score, 0), mask=inside
    )


@partial(jax.jit, static_argnames=("threshold", "contiguous", "interpret"))
def fused_frontend_batch(
    images: jax.Array, *, threshold: int, contiguous: int, interpret: bool = False
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Blur + FAST on (B, H, W) uint8 frames of any H and W.

    Returns ``(blurred u8, corner bool, score i32)``, each (B, H, W), equal
    to ``frontend.detector.blur_fast_reference``.
    """
    if not 1 <= contiguous <= 16:
        raise ValueError(f"contiguous must be in [1, 16], got {contiguous}")
    bsz, h, w = images.shape
    if bsz * h * w >= 2**31:
        # the kernel's flat offsets are int32
        raise ValueError(
            f"{bsz}x{h}x{w} frames hold 2^31 pixels or more; split the batch"
        )
    k2d = gaussian_kernel()
    taps = tuple(
        (dy - BLUR_HALF, dx - BLUR_HALF, float(k2d[dy, dx]))
        for dy in range(2 * BLUR_HALF + 1)
        for dx in range(2 * BLUR_HALF + 1)
    )
    kernel = partial(
        _frontend_kernel, h=h, w=w, threshold=threshold, contiguous=contiguous,
        taps=taps,
    )
    n = bsz * h * w
    blur, corner, score = pl.pallas_call(
        kernel,
        grid=(bsz, pl.cdiv(h, TILE_H), pl.cdiv(w, TILE_W)),
        out_shape=(
            jax.ShapeDtypeStruct((n,), jnp.uint8),
            jax.ShapeDtypeStruct((n,), jnp.uint8),
            jax.ShapeDtypeStruct((n,), jnp.int32),
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="blur_fast",
    )(images.reshape(n))
    shape = (bsz, h, w)
    return blur.reshape(shape), corner.reshape(shape) != 0, score.reshape(shape)
