"""Fused Triton blur+FAST kernel (interpret mode) vs the plain reference,
the platform dispatch between them, and the one orientation+BRIEF path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuslam.frontend.detector import (
    _resize_batch_u8,
    blur_fast_batch,
    blur_fast_impl,
    blur_fast_reference,
)
from tpuslam.kernels.frontend_triton import fused_frontend_batch

ARGS = dict(threshold=20, contiguous=12)
# Same tolerance as on the card (chip_smoke.py): FAST is integer-exact; a
# float32 blur sum on a .5 tie may round either way by one gray level.
BLUR_MAX_DIFF = 1
BLUR_MAX_DIFF_SHARE = 1e-4


def _frames(kitti_frames, shape):
    full = jnp.asarray(np.stack(kitti_frames[:2]))
    if shape == "kitti":  # 512 × 1392
        return full
    if shape == "level1":  # the multiscale pyramid's level 1, 427 × 1160
        return _resize_batch_u8(full, 427, 1160)
    return full[:, 100:200, 300:430]  # odd 100 × 130 crop


@pytest.fixture(scope="module", params=["kitti", "level1", "odd"])
def outputs(request, kitti_frames):
    x = _frames(kitti_frames, request.param)
    got = jax.device_get(fused_frontend_batch(x, interpret=True, **ARGS))
    want = jax.device_get(blur_fast_reference(x, **ARGS))
    return request.param, got, want


def test_triton_blur_matches_reference(outputs):
    name, (blur, _, _), (want, _, _) = outputs
    assert blur.shape == want.shape and blur.dtype == np.uint8
    diff = np.abs(blur.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= BLUR_MAX_DIFF, name
    assert (diff > 0).mean() <= BLUR_MAX_DIFF_SHARE, name


def test_triton_fast_matches_reference(outputs):
    name, (_, corner, score), (_, want_c, want_s) = outputs
    assert corner.dtype == np.bool_ and score.dtype == np.int32
    assert want_c.sum() > 0, name
    np.testing.assert_array_equal(corner, want_c, err_msg=name)
    np.testing.assert_array_equal(score, want_s, err_msg=name)


@pytest.mark.parametrize("platform", ["cpu", "gpu", "rocm"])
def test_blur_fast_impl_by_platform(platform):
    if platform == "cpu":
        assert blur_fast_impl(platform) is blur_fast_reference
    elif platform == "gpu":
        assert blur_fast_impl(platform) is fused_frontend_batch
    else:
        with pytest.raises(ValueError, match="no blur\\+FAST implementation"):
            blur_fast_impl(platform)


def test_blur_fast_batch_lowers_reference_on_cpu(kitti_frames):
    x = jnp.asarray(kitti_frames[0][None, :64, :96])
    lowered = jax.jit(lambda im: blur_fast_batch(im, **ARGS)).lower(x).as_text()
    assert "blur_fast" not in lowered  # no kernel call in the CPU program
    got = jax.device_get(blur_fast_batch(x, **ARGS))
    for g, w in zip(got, jax.device_get(blur_fast_reference(x, **ARGS))):
        np.testing.assert_array_equal(g, w)


def test_kernel_rejects_bad_contiguous():
    with pytest.raises(ValueError, match="contiguous"):
        fused_frontend_batch(
            jnp.zeros((1, 16, 16), jnp.uint8), threshold=20, contiguous=17,
            interpret=True,
        )


def test_kernel_rejects_int32_offset_overflow():
    """Flat pixel offsets are int32: 2^31 pixels in one call are refused
    when traced, before anything is allocated."""
    big = jax.ShapeDtypeStruct((2**11, 2**10, 2**10), jnp.uint8)
    with pytest.raises(ValueError, match="2\\^31"):
        jax.eval_shape(lambda x: fused_frontend_batch(x, interpret=True, **ARGS), big)
    ok = jax.ShapeDtypeStruct((2**11 - 1, 2**10, 2**10), jnp.uint8)
    out = jax.eval_shape(lambda x: fused_frontend_batch(x, interpret=True, **ARGS), ok)
    assert [o.shape for o in out] == [ok.shape] * 3


def test_describe_matches_per_frame_quantized_path(kitti_frames):
    """The detector's one orientation+BRIEF path (patch moments + own-bin
    dots from one patch extraction) equals the map-based orientation and
    the per-frame quantised descriptor path, bit for bit."""
    from tpuslam.config.schema import DetectorConfig
    from tpuslam.frontend.brief import (
        compute_brief_descriptors_quantized,
        compute_orientations,
    )
    from tpuslam.frontend.detector import FeatureDetector

    det = FeatureDetector(DetectorConfig(brief_quantized_bins=16))
    c = det.config
    img = jnp.asarray(kitti_frames[3])
    kps, desc = det.detect_and_compute(img)
    blurred = blur_fast_reference(img[None], **ARGS)[0][0]
    angles = compute_orientations(blurred, kps, c.patch_size)
    want = compute_brief_descriptors_quantized(
        blurred, kps, angles, det.pattern, det.bin_weights, c.num_brief_pairs,
        c.patch_size, c.brief_quantized_bins,
    )
    assert int(kps.valid.sum()) > 100
    np.testing.assert_array_equal(np.asarray(kps.angle), np.asarray(angles))
    np.testing.assert_array_equal(np.asarray(desc), np.asarray(want))


@pytest.mark.gpu
def test_triton_kernel_compiled_for_gpu(gpu, kitti_frames):
    """The kernel as the GPU compiles it (not interpreted) against the plain
    reference run on the host CPU."""
    x = np.stack(kitti_frames[:4])
    got = jax.device_get(fused_frontend_batch(jax.device_put(x, gpu), **ARGS))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        want = jax.device_get(blur_fast_reference(jax.device_put(x, cpu), **ARGS))
    diff = np.abs(got[0].astype(np.int32) - want[0].astype(np.int32))
    assert diff.max() <= BLUR_MAX_DIFF
    assert (diff > 0).mean() <= BLUR_MAX_DIFF_SHARE
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
