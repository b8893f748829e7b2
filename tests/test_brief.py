"""Blur / orientation / BRIEF golden tests against the scalar oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.golden.reference_impl import brief_descriptor, gaussian_blur, orientation
from tpuslam.frontend.brief import (
    compute_brief_descriptors,
    compute_orientations,
    gaussian_blur_u8,
    gaussian_kernel,
    generate_brief_pattern,
)
from tpuslam.frontend.fast import KeypointSet


@pytest.fixture(scope="module")
def crop(kitti_frames):
    return np.ascontiguousarray(kitti_frames[0][160:256, 500:628])


@pytest.fixture(scope="module")
def blurred(crop):
    return np.asarray(gaussian_blur_u8(jnp.asarray(crop), jnp.asarray(gaussian_kernel())))


def make_kps(points, capacity=None):
    pts = np.asarray(points, dtype=np.float32)
    n = len(pts)
    cap = capacity or n
    xy = np.zeros((cap, 2), np.float32)
    xy[:n] = pts
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return KeypointSet(
        xy=jnp.asarray(xy),
        response=jnp.zeros(cap, jnp.float32),
        angle=jnp.zeros(cap, jnp.float32),
        valid=jnp.asarray(valid),
    )


def test_blur_matches_oracle(crop):
    got = np.asarray(gaussian_blur_u8(jnp.asarray(crop), jnp.asarray(gaussian_kernel())))
    want = gaussian_blur(crop)
    # float32 conv vs float64 oracle: allow off-by-one at rare rounding ties
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.001


def test_blur_borders_copied(crop):
    got = np.asarray(gaussian_blur_u8(jnp.asarray(crop), jnp.asarray(gaussian_kernel())))
    np.testing.assert_array_equal(got[:2], crop[:2])
    np.testing.assert_array_equal(got[-2:], crop[-2:])
    np.testing.assert_array_equal(got[:, :2], crop[:, :2])
    np.testing.assert_array_equal(got[:, -2:], crop[:, -2:])


def test_orientation_matches_oracle(crop, blurred):
    pts = [(30, 30), (64, 48), (100, 70), (20, 80), (5, 5)]  # last is border-clipped
    kps = make_kps(pts)
    angles = np.asarray(compute_orientations(jnp.asarray(blurred), kps, patch_size=31))
    for i, (x, y) in enumerate(pts):
        want = orientation(blurred, x, y, 31)
        assert angles[i] == pytest.approx(want, abs=2e-3), (x, y)
    assert angles[4] == 0.0  # clipped → 0 (reference :210-214)


def test_orientation_invalid_keypoints_zero(blurred):
    kps = make_kps([(30, 30)], capacity=4)
    angles = np.asarray(compute_orientations(jnp.asarray(blurred), kps, patch_size=31))
    np.testing.assert_array_equal(angles[1:], 0.0)


def test_pattern_deterministic_and_rejected():
    p1 = generate_brief_pattern(256, 31, seed=42)
    p2 = generate_brief_pattern(256, 31, seed=42)
    np.testing.assert_array_equal(np.asarray(p1.p1), np.asarray(p2.p1))
    n_valid = int(np.asarray(p1.pair_valid).sum())
    assert 0 < n_valid <= 256
    # rejection actually rejects some pairs (σ=1 scaled: ~4/0.13% per coord...)
    scale = 31 / 2
    assert np.abs(np.asarray(p1.p1)).max() < scale


def test_brief_matches_oracle(crop, blurred):
    pattern = generate_brief_pattern(256, 31, seed=42)
    pat_list = [
        (tuple(p1), tuple(p2))
        for p1, p2, v in zip(
            np.asarray(pattern.p1), np.asarray(pattern.p2), np.asarray(pattern.pair_valid)
        )
        if v
    ]
    pts = [(30, 30), (64, 48), (100, 70), (20, 80)]
    angles = [orientation(blurred, x, y, 31) for x, y in pts]
    kps = make_kps(pts)
    descs = np.asarray(
        compute_brief_descriptors(
            jnp.asarray(blurred), kps, jnp.asarray(angles, jnp.float32),
            pattern, num_pairs=256, patch_size=31,
        )
    )
    for i, (x, y) in enumerate(pts):
        want = brief_descriptor(blurred, x, y, angles[i], pat_list, 256, 31)
        np.testing.assert_array_equal(descs[i], want, err_msg=f"kp {i} at {(x, y)}")


def test_brief_border_keypoint_zero(blurred):
    pattern = generate_brief_pattern(256, 31, seed=42)
    kps = make_kps([(5, 5), (30, 30)])
    descs = np.asarray(
        compute_brief_descriptors(
            jnp.asarray(blurred), kps, jnp.zeros(2, jnp.float32), pattern, 256, 31
        )
    )
    assert descs[0].sum() == 0
    assert descs[1].sum() > 0


def test_brief_rotation_changes_descriptor(blurred):
    pattern = generate_brief_pattern(256, 31, seed=42)
    kps = make_kps([(64, 48), (64, 48)])
    descs = np.asarray(
        compute_brief_descriptors(
            jnp.asarray(blurred), kps, jnp.asarray([0.0, 90.0]), pattern, 256, 31
        )
    )
    assert (descs[0] != descs[1]).any()


def test_quantized_brief_agrees_with_exact(crop, blurred):
    """The matmul (angle-quantised) BRIEF path must agree with the exact path
    to within a few bits per descriptor."""
    from tpuslam.frontend.brief import (
        build_brief_bin_weights,
        compute_brief_descriptors_quantized,
    )
    from tests.golden.reference_impl import orientation

    pattern = generate_brief_pattern(256, 31, seed=42)
    W, _ = build_brief_bin_weights(pattern, 31, bins=64)
    pts = [(30, 30), (64, 48), (100, 70), (40, 60)]
    angles = jnp.asarray([orientation(blurred, x, y, 31) for x, y in pts], jnp.float32)
    kps = make_kps(pts)
    exact = np.asarray(
        compute_brief_descriptors(jnp.asarray(blurred), kps, angles, pattern, 256, 31)
    )
    quant = np.asarray(
        compute_brief_descriptors_quantized(
            jnp.asarray(blurred), kps, angles, pattern, jnp.asarray(W), 256, 31, 64
        )
    )
    for i in range(len(pts)):
        ham = bin(
            int.from_bytes(exact[i].tobytes(), "big")
            ^ int.from_bytes(quant[i].tobytes(), "big")
        ).count("1")
        assert ham <= 24, f"kp {i}: {ham} bits differ"


def test_quantized_brief_zero_angle_exact_match(crop, blurred):
    """At angle exactly 0 the quantised path must be bit-identical."""
    from tpuslam.frontend.brief import (
        build_brief_bin_weights,
        compute_brief_descriptors_quantized,
    )

    pattern = generate_brief_pattern(256, 31, seed=42)
    W, _ = build_brief_bin_weights(pattern, 31, bins=64)
    pts = [(30, 30), (64, 48), (100, 70)]
    kps = make_kps(pts)
    zeros = jnp.zeros(3, jnp.float32)
    exact = np.asarray(
        compute_brief_descriptors(jnp.asarray(blurred), kps, zeros, pattern, 256, 31)
    )
    quant = np.asarray(
        compute_brief_descriptors_quantized(
            jnp.asarray(blurred), kps, zeros, pattern, jnp.asarray(W), 256, 31, 64
        )
    )
    np.testing.assert_array_equal(exact, quant)
