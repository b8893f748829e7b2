"""FeatureDetector facade: FAST detect + steered-BRIEF compute.

The JAX analog of the reference's ``FeatureDetector`` class
(``include/slam/frontend/feature_detector.hpp:48-135``): construction loads
and validates the YAML config and fixes the BRIEF pattern once; ``detect``,
``compute`` and ``detect_and_compute`` are jitted, batchable pure functions.
"""

from __future__ import annotations

import os
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp

from tpuslam.config.schema import DetectorConfig
from tpuslam.frontend.brief import (
    BriefPattern,
    build_brief_bin_weights,
    compute_brief_descriptors,
    compute_orientations,
    disc_moment_weights,
    extract_brief_patches_i8,
    gaussian_blur_u8,
    gaussian_kernel,
    generate_brief_pattern,
    orientations_from_patches,
    quantized_brief_from_patches,
)
from tpuslam.frontend.fast import (
    KeypointSet,
    detect_keypoints,
    fast_response_and_mask,
    select_keypoints,
)


def blur_fast_reference(
    images: jax.Array, *, threshold: int, contiguous: int
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Plain XLA blur + FAST over (B, H, W) uint8 frames.

    Returns ``(blurred u8, corner bool, score i32)``, each (B, H, W).
    """
    kernel = jnp.asarray(gaussian_kernel())
    blur = jax.vmap(lambda im: gaussian_blur_u8(im, kernel))(images)
    corner, score = jax.vmap(
        lambda im: fast_response_and_mask(im, threshold, contiguous)
    )(images)
    return blur, corner, score


def blur_fast_impl(platform: str):
    """The blur + FAST implementation for a JAX platform name.

    ``"cpu"`` runs the plain reference; ``"gpu"`` the fused Triton kernel
    (``kernels/frontend_triton.py``).  Any other platform has no frontend.
    """
    if platform == "cpu":
        return blur_fast_reference
    if platform == "gpu":
        from tpuslam.kernels.frontend_triton import fused_frontend_batch

        return fused_frontend_batch
    raise ValueError(f"no blur+FAST implementation for platform {platform!r}")


def blur_fast_batch(
    images: jax.Array, *, threshold: int, contiguous: int
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Blur + FAST on (B, H, W) uint8 frames, chosen by where XLA compiles.

    The choice is made when the program is lowered, so one jitted pipeline
    placed on the CPU (tests, the in-process reference run) takes the plain
    path and placed on a GPU takes the kernel; lowering for any other
    platform fails.
    """
    args = dict(threshold=threshold, contiguous=contiguous)
    return jax.lax.platform_dependent(
        images,
        cpu=partial(blur_fast_impl("cpu"), **args),
        cuda=partial(blur_fast_impl("gpu"), **args),
    )


class FeatureDetector:
    """Stateless-after-init detector; all methods are jit-compiled."""

    def __init__(self, config: DetectorConfig | str | Path):
        if not isinstance(config, DetectorConfig):
            config = DetectorConfig.from_yaml(config)
        self.config = config
        self.pattern: BriefPattern = generate_brief_pattern(
            config.num_brief_pairs, config.patch_size, seed=config.brief_seed
        )
        self.blur_kernel = jnp.asarray(gaussian_kernel())
        self.bin_weights = None
        if config.brief_quantized_bins > 0:
            W, _ = build_brief_bin_weights(
                self.pattern, config.patch_size, config.brief_quantized_bins
            )
            self.bin_weights = jnp.asarray(W)
        self.moment_weights = jnp.asarray(disc_moment_weights(config.patch_size))

    # --- detect ---------------------------------------------------------------
    def detect(self, image: jax.Array) -> KeypointSet:
        """FAST + NMS on one (H, W) uint8 image → fixed-capacity KeypointSet."""
        c = self.config
        return detect_keypoints(
            image,
            threshold=c.intensity_threshold,
            contiguous=c.contiguous_pixels_threshold,
            nms=c.non_max_suppression,
            window=c.suppression_window_size,
            max_keypoints=c.max_keypoints,
        )

    # --- compute --------------------------------------------------------------
    def compute(self, image: jax.Array, kps: KeypointSet) -> tuple[KeypointSet, jax.Array]:
        """Blur + orientation + BRIEF. Returns (keypoints-with-angles, descriptors).

        Descriptors: (K, num_brief_pairs/8) uint8; rows for invalid keypoints
        are all-zero.
        """
        return _compute_impl(
            image,
            kps,
            self.blur_kernel,
            self.pattern,
            self.bin_weights,
            self.moment_weights,
            self.config.num_brief_pairs,
            self.config.patch_size,
            self.config.brief_quantized_bins,
        )

    def detect_and_compute(self, image: jax.Array) -> tuple[KeypointSet, jax.Array]:
        """One (H, W) frame through :meth:`detect_and_compute_batch`."""
        kps, desc = self.detect_and_compute_batch(image[None])
        return jax.tree.map(lambda a: a[0], kps), desc[0]

    # --- batched --------------------------------------------------------------
    def detect_and_compute_batch(self, images: jax.Array) -> tuple[KeypointSet, jax.Array]:
        """Batched detect+compute over (B, H, W) frames.

        With ``num_levels > 1`` this runs the ORB-style image pyramid
        (BASELINE config 4): each level detects + describes on a
        1/scale_factor^l-resized image and its keypoints map back to level-0
        pixels, so blur/scale-degraded structure still yields matchable
        features.  The reference is single-scale
        (``feature_detector.cpp:56-68`` scans one image); the pyramid is the
        standard ORB extension, capacity-split by level area so the
        concatenated keypoint set keeps the fixed ``max_keypoints`` shape.
        """
        c = self.config
        if c.num_levels <= 1:
            return self._level_batch(images, c.max_keypoints)
        return self._pyramid_batch(images)

    def _level_batch(
        self, images: jax.Array, max_keypoints: int
    ) -> tuple[KeypointSet, jax.Array]:
        """Single-scale batched detect+compute with an explicit capacity."""
        c = self.config
        blur, corner, score = blur_fast_batch(
            images,
            threshold=c.intensity_threshold,
            contiguous=c.contiguous_pixels_threshold,
        )
        kps = jax.vmap(
            lambda co, sc: select_keypoints(
                co, sc, nms=c.non_max_suppression,
                window=c.suppression_window_size, max_keypoints=max_keypoints,
            )
        )(corner, score)
        return jax.vmap(self._describe)(blur, kps)

    def _describe(
        self, blurred: jax.Array, kps: KeypointSet
    ) -> tuple[KeypointSet, jax.Array]:
        c = self.config
        return _compute_from_blurred(
            blurred, kps, self.pattern, self.bin_weights, self.moment_weights,
            c.num_brief_pairs, c.patch_size, c.brief_quantized_bins,
        )

    def _feasible_levels(self, h: int, w: int) -> list[tuple[int, int, int]]:
        """(level, h_l, w_l) for every level large enough to detect on."""
        c = self.config
        out = []
        min_side = 4 * c.patch_size
        for level in range(c.num_levels):
            s = c.scale_factor**level
            h_l, w_l = int(round(h / s)), int(round(w / s))
            if min(h_l, w_l) < min_side:
                break
            out.append((level, h_l, w_l))
        return out

    def _pyramid_batch(self, images: jax.Array) -> tuple[KeypointSet, jax.Array]:
        c = self.config
        B, H, W = images.shape
        levels = self._feasible_levels(H, W)
        # capacity ∝ level area, summing exactly to max_keypoints
        weights = [(w_l * h_l) for (_, h_l, w_l) in levels]
        total = float(sum(weights))
        caps = [max(32, int(round(c.max_keypoints * wt / total))) for wt in weights]
        caps[0] += c.max_keypoints - sum(caps)

        # OFF by default: bit-identical to the loop (test_pyramid); an
        # experiment that runs blur+FAST once over all levels stacked.
        if len(levels) > 1 and os.environ.get(
            "TPUSLAM_PYRAMID_CANVAS", "0"
        ) == "1":
            return self._pyramid_batch_canvas(images, levels, caps)

        # Cascade: resize each level from the PREVIOUS level (the OpenCV
        # ORB buildPyramid convention) instead of from level 0 — reads
        # shrink geometrically instead of paying the full-resolution image
        # per level.  Interpolation compounds slightly (bilinear of
        # bilinear); the pyramid quality tests gate the behaviour.
        cascade = os.environ.get("TPUSLAM_PYRAMID_CASCADE", "0") == "1"
        kp_parts: list[KeypointSet] = []
        desc_parts: list[jax.Array] = []
        prev = images
        for (level, h_l, w_l), cap in zip(levels, caps):
            if level == 0:
                img = images
            else:
                img = _resize_batch_u8(prev if cascade else images, h_l, w_l)
            prev = img
            kps, desc = self._level_batch(img, cap)
            scale = jnp.float32(c.scale_factor**level)
            kps = kps._replace(xy=kps.xy * scale)
            kp_parts.append(kps)
            desc_parts.append(desc)
        kps = jax.tree.map(lambda *parts: jnp.concatenate(parts, axis=1), *kp_parts)
        return kps, jnp.concatenate(desc_parts, axis=1)

    def _pyramid_batch_canvas(
        self, images: jax.Array, levels, caps
    ) -> tuple[KeypointSet, jax.Array]:
        """Pyramid detect via ONE stacked-canvas blur+FAST pass.

        The per-level loop pays a blur+FAST launch per level; here all
        levels stack vertically into one (B, ΣH_l, W) canvas and blur
        + FAST run ONCE over it.  Bit-exactness with the per-level loop
        (asserted by test_pyramid) holds because every per-level edge
        rule is reapplied in level coordinates:

        * corners live ≥3 px inside a level, so FAST's reads never cross
          a level boundary; a static per-level border-3 mask removes the
          canvas-computed corners outside that region (incl. everything
          in other levels' columns);
        * NMS + tile-pooled top-k run per level on SLICES of the canvas
          corner/score planes — identical inputs ⇒ identical keypoints
          (and slice-local packed keys keep the <2^20 exact-index
          guarantee the canvas as a whole would lose);
        * the 5×5 blur's interior (≥2 px inside a level) never reads
          across a boundary, and the reference border-copy rule is
          reapplied per level before BRIEF.
        """
        c = self.config
        B, H, W = images.shape
        import numpy as np

        origins = []
        o = 0
        for (_, h_l, _) in levels:
            origins.append(o)
            o += h_l
        H_canvas = o

        canvas = jnp.zeros((B, H_canvas, W), jnp.uint8)
        imgs = []
        for (level, h_l, w_l), o_l in zip(levels, origins):
            img = images if level == 0 else _resize_batch_u8(images, h_l, w_l)
            canvas = jax.lax.dynamic_update_slice(canvas, img, (0, o_l, 0))
            imgs.append(img)

        blur_c, corner_c, score_c = blur_fast_batch(
            canvas,
            threshold=c.intensity_threshold,
            contiguous=c.contiguous_pixels_threshold,
        )

        # static per-level border-3 interior mask (kills gap/cross-level
        # corners and reapplies each level's FAST border exclusion)
        mask = np.zeros((H_canvas, W), bool)
        for (_, h_l, w_l), o_l in zip(levels, origins):
            mask[o_l + 3 : o_l + h_l - 3, 3 : w_l - 3] = True
        corner_c = corner_c & jnp.asarray(mask)[None]

        kp_parts: list[KeypointSet] = []
        desc_parts: list[jax.Array] = []
        for (level, h_l, w_l), o_l, cap, img in zip(
            levels, origins, caps, imgs
        ):
            sl_corner = jax.lax.slice(
                corner_c, (0, o_l, 0), (B, o_l + h_l, w_l)
            )
            sl_score = jax.lax.slice(
                score_c, (0, o_l, 0), (B, o_l + h_l, w_l)
            )
            kps = jax.vmap(
                lambda co, sc, cap=cap: select_keypoints(
                    co, sc, nms=c.non_max_suppression,
                    window=c.suppression_window_size, max_keypoints=cap,
                )
            )(sl_corner, sl_score)
            blur_l = jax.lax.slice(blur_c, (0, o_l, 0), (B, o_l + h_l, w_l))
            # reference blur border rule, per level (the canvas pass
            # applied it at canvas edges only)
            row = jnp.arange(h_l)[:, None]
            col = jnp.arange(w_l)[None, :]
            border = (
                (row < 2) | (row >= h_l - 2) | (col < 2) | (col >= w_l - 2)
            )
            blur_l = jnp.where(border[None], img, blur_l)
            kps2, desc = jax.vmap(self._describe)(blur_l, kps)
            scale = jnp.float32(c.scale_factor**level)
            kps2 = kps2._replace(xy=kps2.xy * scale)
            kp_parts.append(kps2)
            desc_parts.append(desc)
        kps = jax.tree.map(
            lambda *parts: jnp.concatenate(parts, axis=1), *kp_parts
        )
        return kps, jnp.concatenate(desc_parts, axis=1)


@partial(jax.jit, static_argnames=("h_out", "w_out"))
def _resize_batch_u8(images: jax.Array, h_out: int, w_out: int) -> jax.Array:
    """Bilinear (B, H, W) uint8 resize — the pyramid downscale.

    DEFAULT matmul precision, not jax.image.resize's HIGHEST: pixel values
    are exact at any matmul precision (integers ≤ 255), and rounded
    weights move a few pixels of an already low-pass-filtered downsample
    by ≤ 2 gray levels, far below the FAST intensity threshold (20).  On
    the CPU, DEFAULT is full float32.
    """
    precision = (
        jax.lax.Precision.HIGHEST
        if os.environ.get("TPUSLAM_RESIZE_HIGHEST") == "1"
        else jax.lax.Precision.DEFAULT
    )
    out = jax.image.resize(
        images.astype(jnp.float32),
        (images.shape[0], h_out, w_out),
        method="linear",
        precision=precision,
    )
    return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("num_pairs", "patch_size", "quantized_bins"))
def _compute_impl(
    image: jax.Array,
    kps: KeypointSet,
    blur_kernel: jax.Array,
    pattern: BriefPattern,
    bin_weights: jax.Array | None,
    moment_weights: jax.Array,
    num_pairs: int,
    patch_size: int,
    quantized_bins: int,
) -> tuple[KeypointSet, jax.Array]:
    blurred = gaussian_blur_u8(image, blur_kernel)
    return _compute_from_blurred(
        blurred, kps, pattern, bin_weights, moment_weights, num_pairs,
        patch_size, quantized_bins,
    )


@partial(jax.jit, static_argnames=("num_pairs", "patch_size", "quantized_bins"))
def _compute_from_blurred(
    blurred: jax.Array,
    kps: KeypointSet,
    pattern: BriefPattern,
    bin_weights: jax.Array | None,
    moment_weights: jax.Array,
    num_pairs: int,
    patch_size: int,
    quantized_bins: int,
) -> tuple[KeypointSet, jax.Array]:
    """Orientation + BRIEF for one frame's keypoints.

    The quantised path extracts each keypoint's patch once and takes both
    the orientation moments (an int8 product with the disc weights, equal
    to :func:`compute_orientations`) and the own-bin BRIEF dots from it.
    """
    if quantized_bins > 0 and bin_weights is not None:
        patches = extract_brief_patches_i8(blurred, kps, patch_size)
        angles = orientations_from_patches(
            patches, moment_weights, kps, patch_size, blurred.shape
        )
        descriptors = quantized_brief_from_patches(
            patches, kps, angles, pattern, bin_weights, num_pairs, patch_size,
            quantized_bins, blurred.shape,
        )
    else:
        angles = compute_orientations(blurred, kps, patch_size)
        descriptors = compute_brief_descriptors(
            blurred, kps, angles, pattern, num_pairs, patch_size
        )
    return kps._replace(angle=angles), descriptors
