"""Per-stage timing of the VO pipeline on the GPU.

Each stage of the *real* pipeline path (the same functions
``SlamPipeline._process_chunk`` composes) is timed at steady state over the
batch-16 KITTI fixture chunk the benchmark uses, so stage costs add up to
(roughly) the per-chunk cost of the fused pipeline.

Timing methodology (``honest``): every dispatch gets a distinct traced
``salt`` scalar folded into a *numeric input* and reduces its outputs to one
float32 scalar.  The float reduction defeats XLA dead-code elimination
(integer outputs can be constant-folded and whole stages dropped).  N
dispatches are enqueued before one ``block_until_ready``.  Roofline columns
use the published peaks of the device kind (``utils/profiling.PEAKS``).
"""

from __future__ import annotations

import sys
import time
from functools import partial
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.common.camera import Camera, undistort_image
from tpuslam.config.schema import SlamConfig
from tpuslam.frontend.matcher import match_descriptors
from tpuslam.frontend.pose import estimate_relative_pose
from tpuslam.model.slam import SlamPipeline
from tpuslam.pre.stream import FrameStream
from tpuslam.utils.profiling import peaks_for

BATCH = 16
N_REPS = 30


def _to_scalar(out) -> jax.Array:
    leaves = [a for a in jax.tree.leaves(out) if isinstance(a, jax.Array)]
    acc = jnp.float32(0.0)
    for a in leaves:
        acc = acc + jnp.sum(a.astype(jnp.float32))
    return acc


def _cost_analysis(compiled) -> tuple[float, float]:
    """(flops, bytes accessed) from XLA's cost model; (0, 0) if unsupported."""
    try:
        cost = compiled.cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0] if cost else {}
        return float(cost.get("flops", 0.0)), float(
            cost.get("bytes accessed", 0.0)
        )
    except Exception:
        return 0.0, 0.0


def honest(tag: str, fn, *args, salted: int = 0, n: int = N_REPS) -> None:
    """Print steady-state ms/frame + roofline columns of ``fn(*args)``.

    ``salted``: index of the positional arg to perturb per dispatch (must be
    a numeric jax array; the salt is added elementwise, wrapping for uint8).
    """

    @jax.jit
    def run(salt, *a):
        a = list(a)
        a[salted] = a[salted] + salt.astype(a[salted].dtype)
        return _to_scalar(fn(*a))

    lowered = run.lower(jnp.int32(0), *args)
    flops, nbytes = _cost_analysis(lowered.compile())
    r = run(jnp.int32(0), *args)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for i in range(n):
        r = run(jnp.int32(i % 3), *args)
    jax.block_until_ready(r)
    dt = (time.perf_counter() - t0) / n
    if flops or nbytes:
        peaks = peaks_for(jax.devices()[0].device_kind)
        tf = flops / dt / 1e12
        gb = nbytes / dt / 1e9
        # Roofline verdict: which ceiling is closer, or neither (latency).
        mfu = tf * 1e12 / peaks["bf16_flops"]
        bwu = gb * 1e9 / peaks["hbm_bytes"]
        kind = (
            "latency" if max(mfu, bwu) < 0.05
            else ("compute" if mfu >= bwu else "bandwidth")
        )
        print(
            f"{tag:26s}{dt * 1e3 / BATCH:8.3f} ms/frame "
            f"{flops / BATCH / 1e9:8.2f} GF/fr {tf:7.2f} TF/s "
            f"({100 * mfu:5.1f}% bf16 peak) {gb:6.0f} GB/s "
            f"({100 * bwu:5.1f}% HBM)  [{kind}-bound]"
        )
    else:
        print(f"{tag:26s}{dt * 1e3 / BATCH:8.3f} ms/frame")


def main() -> None:
    camera = Camera.from_yaml(REPO_ROOT / "configs" / "camera.yml")
    config = SlamConfig.from_yaml_dir(REPO_ROOT / "configs", batch_size=BATCH)
    pipeline = SlamPipeline(camera, config)
    det = pipeline.detector
    c = det.config

    stream = FrameStream(REPO_ROOT / "tests" / "data" / "images")
    base = [stream.read_frame(i)[0] for i in range(stream.total_frames)]
    frames = jnp.asarray(np.stack([base[i % len(base)] for i in range(BATCH)]))

    # --- stage 1: undistort -------------------------------------------------
    und_fn = jax.vmap(
        lambda f: undistort_image(
            f, pipeline._undistort_idx, pipeline._undistort_valid, normalize=False
        )
    )
    honest("undistort", und_fn, frames)
    und = jax.jit(und_fn)(frames)

    # --- stage 2: blur + FAST corner/score ----------------------------------
    from tpuslam.frontend.detector import _compute_from_blurred, blur_fast_batch

    ff = partial(
        blur_fast_batch,
        threshold=c.intensity_threshold,
        contiguous=c.contiguous_pixels_threshold,
    )
    honest("blur+FAST", ff, und)
    blur, corner, score = jax.jit(ff)(und)

    # --- stage 3: NMS + top-k select ----------------------------------------
    from tpuslam.frontend.fast import select_keypoints

    sel = jax.vmap(
        lambda co, sc: select_keypoints(
            co, sc, nms=c.non_max_suppression,
            window=c.suppression_window_size, max_keypoints=c.max_keypoints,
        )
    )
    honest("NMS+topk", sel, corner, score, salted=1)
    kps = jax.jit(sel)(corner, score)

    # --- stage 4: orientation + BRIEF ----------------------------------------
    cfb = jax.vmap(
        lambda bl, k: _compute_from_blurred(
            bl, k, det.pattern, det.bin_weights, det.moment_weights,
            c.num_brief_pairs, c.patch_size, c.brief_quantized_bins,
        )
    )
    honest("orient+BRIEF", cfb, blur, kps)
    _, desc = jax.jit(cfb)(blur, kps)

    # --- stage 5: matcher (consecutive pairs within the chunk) ----------------
    mcfg = config.matcher
    desc_q = jnp.concatenate([desc[:1], desc[:-1]], axis=0)
    match_fn = jax.vmap(
        lambda d1, d2, k1v, k2v, k1x, k2x: match_descriptors(
            d1, d2, k1v, k2v, k1x, k2x,
            ratio_threshold=mcfg.ratio_test_threshold,
            max_jump_radius=mcfg.max_jump_radius,
            use_ratio_test=mcfg.use_ratio_test,
            filter_matches=False,
            use_spatial_penalty=True,
        )
    )
    honest("match", match_fn, desc_q, desc, kps.valid, kps.valid, kps.xy, kps.xy, salted=4)
    match = jax.jit(match_fn)(desc_q, desc, kps.valid, kps.valid, kps.xy, kps.xy)

    # --- stage 6: pose RANSAC -------------------------------------------------
    pcfg = config.pose
    q = jnp.maximum(match.query_idx, 0)
    tr = jnp.maximum(match.train_idx, 0)
    pts1 = jnp.take_along_axis(kps.xy, q[..., None], axis=1)
    pts2 = jnp.take_along_axis(kps.xy, tr[..., None], axis=1)
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    K = pipeline._K
    pose_fn = jax.vmap(
        lambda p1, p2, v, k: estimate_relative_pose(
            p1, p2, v, K, k,
            num_hypotheses=pcfg.num_hypotheses,
            sample_size=pcfg.sample_size,
            inlier_threshold_px=pcfg.inlier_threshold_px,
            min_matches=pcfg.min_matches,
        )
    )
    honest("pose RANSAC", pose_fn, pts1, pts2, match.valid, keys)
    res = jax.jit(pose_fn)(pts1, pts2, match.valid, keys)

    # --- stage 7: triangulation ----------------------------------------------
    from tpuslam.frontend.pose import triangulate_matched_points

    tri = jax.vmap(lambda R, t_, p1, p2: triangulate_matched_points(K, R, t_, p1, p2))
    honest("triangulation", tri, res.R, res.t, pts1, pts2, salted=2)

    # --- full chunk program for comparison -------------------------------------
    state = pipeline.initial_state()
    valid = jnp.ones(BATCH, bool)
    key = jax.random.PRNGKey(0)

    def full(fr, st, k):
        result, st2 = pipeline._process_chunk(fr, valid, st, k)
        return result.poses

    honest("full chunk", full, frames, state, key)


if __name__ == "__main__":
    main()
