#!/usr/bin/env python
"""On-card smoke test: tpuslam's main path on one NVIDIA GPU.

Run from the root of a checkout on a machine with a GPU:

    python chip_smoke.py              # device, kernel and main-path phases
    python chip_smoke.py --ab         # ... then the kernel-vs-plain timing A/B
    python chip_smoke.py --devices 4  # only the four-GPU paths

Phases (one process, which holds the card throughout):

1. device — the card's name and power limit; refuses to run unless JAX's
   first device is a GPU.
2. kernel — compiles the Triton blur+FAST kernel at the KITTI width and at
   every pyramid level width, prints its memory analysis, and compares it
   with the plain reference run on the host CPU.
3. main path — ``tools/cli.py``'s ``main()`` on the 10 KITTI fixture frames
   in VO, PnP, SLAM, SLAM-PnP (saving a checkpoint), localization against
   that checkpoint, and the multi-scale profile; then the whole VO
   trajectory on the GPU against the same pipeline on the host CPU.
4. A/B (``--ab``) — VO end to end (B=16, the 96-frame ping-pong clip) with
   the kernel and with the plain path, in turns A, B, B, A; the frontend
   stage alone; and profiler-trace device times of the stages left to XLA.

``--devices 4`` runs only the cross-device paths, each against its
one-device run: multi-sequence SLAM sharded over four GPUs, and the CLI's
``--timeshard 4``.

The last line of standard output is one JSON object,
``{"ok": ..., "device": {"platform", "kind", "count"}}``.  A phase that
fails prints its error and makes that line ``"ok": false``, exit code 1.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from functools import partial
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent
IMAGES = REPO_ROOT / "tests" / "data" / "images"

# --- tolerances ---------------------------------------------------------------
# FAST corners and scores are integer arithmetic: the kernel must match the
# reference bit for bit.
# The blur is a float32 sum of 25 products rounded half up.  The GPU may
# contract a product and an add into one FMA, which rounds once instead of
# twice and can move a sum that sits on a .5 tie by one gray level.
BLUR_MAX_DIFF = 1  # gray levels
BLUR_MAX_DIFF_SHARE = 1e-4  # of all pixels (0.01%)
# GPU vs CPU trajectory: the same program on two backends differs in the
# last bits of float sums (and in TF32 for any unpinned f32 matmul), which
# can flip a RANSAC ranking; the poses must still agree within 1% of the
# path length after Sim(3) alignment.
TRAJ_ATE_SHARE = 0.01
# Expectations of the 10-frame KITTI fixture (forward motion, ~1 m/frame):
# 9 tracked frame pairs, z marching forward to about 9 at unit-ish scale,
# lateral and vertical drift under 0.2.
FIXTURE_POSE_OK = 9
FIXTURE_Z_FINAL = (8.0, 10.0)
FIXTURE_XY_DRIFT = 0.2
# Cross-device runs: multi-sequence shards must reproduce the one-device
# run of the same input within the GPU-vs-CPU bound; the time-sharded
# trajectory within the bound of tests/test_timeshard.py (5% of path).
TIMESHARD_ATE_SHARE = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def path_length(poses) -> float:
    import numpy as np

    p = np.asarray(poses)[:, :3, 3]
    return float(np.linalg.norm(np.diff(p, axis=0), axis=1).sum())


def load_cli():
    spec = importlib.util.spec_from_file_location("tpuslam_cli", REPO_ROOT / "tools" / "cli.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


def fixture_frames():
    import numpy as np

    from tpuslam.pre.stream import FrameStream

    stream = FrameStream(IMAGES)
    return np.stack([stream.read_frame(i)[0] for i in range(stream.total_frames)])


def ping_pong(base, n: int):
    """0..9, 8..1, 0..9, …: a continuous camera path over the fixture."""
    import numpy as np

    period = 2 * (len(base) - 1)
    return np.stack([base[min(i % period, period - i % period)] for i in range(n)])


# --- phase 1 -------------------------------------------------------------------
def phase_device(expect_count: int) -> None:
    import jax

    devs = jax.devices()
    log(f"[device] {len(devs)} x {devs[0].platform} {devs[0].device_kind}")
    if devs[0].platform != "gpu":
        raise RuntimeError(f"JAX's first device is {devs[0].platform!r}, not a GPU")
    if len(devs) < expect_count:
        raise RuntimeError(f"{len(devs)} GPUs visible, {expect_count} needed")


# --- phase 2 -------------------------------------------------------------------
def kernel_cases():
    """(name, (B, H, W) u8 frames): KITTI width, each pyramid level, odd crop."""
    import jax
    import jax.numpy as jnp

    from tpuslam.config.schema import DetectorConfig
    from tpuslam.frontend.detector import FeatureDetector, _resize_batch_u8

    frames = ping_pong(fixture_frames(), 16)
    det = FeatureDetector(
        DetectorConfig.from_yaml(REPO_ROOT / "configs" / "multiscale" / "feature_detector.yml")
    )
    cases = [("kitti", frames)]
    with jax.default_device(jax.devices("cpu")[0]):
        for level, h_l, w_l in det._feasible_levels(*frames.shape[1:])[1:]:
            lv = _resize_batch_u8(jnp.asarray(frames), h_l, w_l)
            cases.append((f"level{level}", jax.device_get(lv)))
    cases.append(("odd", frames[:, 100:200, 300:430]))
    return det.config, cases


def phase_kernel() -> None:
    import jax
    import numpy as np

    from tpuslam.frontend.detector import blur_fast_reference
    from tpuslam.kernels.frontend_triton import fused_frontend_batch

    cfg, cases = kernel_cases()
    args = dict(threshold=cfg.intensity_threshold, contiguous=cfg.contiguous_pixels_threshold)
    cpu = jax.devices("cpu")[0]
    for name, frames in cases:
        x = jax.device_put(frames, jax.devices()[0])
        compiled = jax.jit(partial(fused_frontend_batch, **args)).lower(x).compile()
        log(f"[kernel] {name} {frames.shape}: {compiled.memory_analysis()}")
        blur, corner, score = jax.device_get(compiled(x))
        with jax.default_device(cpu):
            rb, rc, rs = jax.device_get(
                jax.jit(partial(blur_fast_reference, **args))(jax.device_put(frames, cpu))
            )
        n_corner = int((corner != rc).sum())
        n_score = int((score != rs).sum())
        diff = np.abs(blur.astype(np.int32) - rb.astype(np.int32))
        share = float((diff > 0).mean())
        log(
            f"[kernel] {name}: corners {int(rc.sum())}, corner mismatches "
            f"{n_corner}, score mismatches {n_score}, blur max diff "
            f"{int(diff.max())} on {int((diff > 0).sum())} px ({share:.2e})"
        )
        if n_corner or n_score:
            raise AssertionError(f"{name}: FAST corner/score differ from the reference")
        if diff.max() > BLUR_MAX_DIFF or share > BLUR_MAX_DIFF_SHARE:
            raise AssertionError(f"{name}: blur outside tolerance")


# --- phase 3 -------------------------------------------------------------------
def run_cli(cli, argv: list[str]) -> dict:
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {' '.join(argv)} returned {rc}")
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    stats["wall_s"] = round(time.perf_counter() - t0, 3)
    return stats


def check_fixture_trajectory(name: str, stats: dict, traj_path: Path) -> None:
    import numpy as np

    xyz = np.loadtxt(traj_path).reshape(-1, 3, 4)[:, :, 3]
    log(
        f"[main] {name}: {json.dumps(stats)} final xyz "
        f"{np.array2string(xyz[-1], precision=3)} max |x| {abs(xyz[:, 0]).max():.3f} "
        f"max |y| {abs(xyz[:, 1]).max():.3f}"
    )
    if stats["frames"] != 10 or stats["pose_ok"] != FIXTURE_POSE_OK:
        raise AssertionError(f"{name}: frames/pose_ok {stats['frames']}/{stats['pose_ok']}")
    lo, hi = FIXTURE_Z_FINAL
    if not (lo <= xyz[-1, 2] <= hi) or (np.diff(xyz[:, 2]) < 0).any():
        raise AssertionError(f"{name}: z does not march forward to ~9: {xyz[:, 2]}")
    if np.abs(xyz[:, :2]).max() >= FIXTURE_XY_DRIFT:
        raise AssertionError(f"{name}: x/y drift {np.abs(xyz[:, :2]).max():.3f}")


def vo_trajectory(device):
    import jax

    from tpuslam.common.camera import Camera
    from tpuslam.config.schema import SlamConfig
    from tpuslam.model.slam import SlamPipeline
    from tpuslam.pre.stream import FrameStream

    with jax.default_device(device):
        camera = Camera.from_yaml(REPO_ROOT / "configs" / "camera.yml")
        config = SlamConfig.from_yaml_dir(REPO_ROOT / "configs", batch_size=5)
        pipeline = SlamPipeline(camera, config)
        return pipeline.run(FrameStream(IMAGES).batches(5), seed=0)["poses"]


def median_ms(fn, n: int = 20) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def report_decoder() -> None:
    """Which decoder ``FrameStream`` uses for the fixture, and the host time
    of each decoder on its first frame."""
    import numpy as np

    from tpuslam.pre.png import read_png_gray
    from tpuslam.pre.stream import FrameStream

    first = sorted(IMAGES.glob("*.png"))[0]
    png_line = f"pre/png.py {median_ms(lambda: read_png_gray(first)):.3f} ms"
    stream = FrameStream(IMAGES)
    if stream._native is None:
        try:
            from tpuslam.pre.native_loader import NativeFrameLoader

            NativeFrameLoader(IMAGES)
            why = "no error on a second try"
        except Exception as e:
            why = f"{type(e).__name__}: {e}"
        log(f"[main] FrameStream decoder: pre/png.py (native loader unavailable: {why}); "
            f"first fixture frame: {png_line}")
        return
    if not np.array_equal(stream._native.decode_batch(0, 1)[0], read_png_gray(first)):
        raise AssertionError("the native loader and pre/png.py decode a fixture frame differently")
    native_ms = median_ms(lambda: stream._native.decode_batch(0, 1))
    log(f"[main] FrameStream decoder: native loader; first fixture frame: native "
        f"{native_ms:.3f} ms, {png_line} (median of 20)")


def phase_main(work: Path) -> None:
    import jax

    from tpuslam.post.trajectory import ate_rmse

    report_decoder()
    cli = load_cli()
    ckpt = work / "slam_pnp.npz"
    modes = [
        ("vo", "configs", ["--tracking", "vo"]),
        ("pnp", "configs", ["--tracking", "pnp"]),
        ("slam", "configs", ["--slam"]),
        ("slam-pnp", "configs", ["--slam", "--tracking", "pnp", "--save-state", str(ckpt)]),
        ("localize", "configs", ["--localize", str(ckpt)]),
        ("multiscale", "configs/multiscale", []),
    ]
    for name, cfg, extra in modes:
        out = work / f"{name}.txt"
        stats = run_cli(cli, [
            "-c", str(REPO_ROOT / cfg), "-v", str(IMAGES), "-o", str(out),
            "--batch-size", "5", "--stats", *extra,
        ])
        check_fixture_trajectory(name, stats, out)

    gpu = vo_trajectory(jax.devices()[0])
    cpu = vo_trajectory(jax.devices("cpu")[0])
    ate, path = ate_rmse(gpu, cpu), path_length(cpu)
    log(f"[main] VO GPU vs CPU: ATE {ate:.5f} over path {path:.3f} ({ate / path:.2e})")
    if ate >= TRAJ_ATE_SHARE * path:
        raise AssertionError("GPU trajectory departs from the CPU run")


# --- phase 4 -------------------------------------------------------------------
def device_ms(fn, args, n: int, work: Path, tag: str) -> float:
    """Mean device busy milliseconds per call of a jitted ``fn`` from a trace."""
    import jax

    from tpuslam.utils.profiling import device_busy_ns, device_trace

    jax.block_until_ready(fn(*args))
    log_dir = work / f"trace_{tag}"
    if log_dir.exists():
        raise ValueError(f"trace directory {log_dir} is already used")
    with device_trace(str(log_dir)):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
        window = time.perf_counter_ns() - t0
    busy = device_busy_ns(log_dir, window_ns=window)
    if len(busy) != 1:
        raise AssertionError(f"trace {tag}: expected one GPU, got {sorted(busy)}")
    return sum(busy.values()) / n / 1e6


def wall_ms(fn, args, n: int) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase_ab(work: Path, batch: int = 16, n_frames: int = 96, reps: int = 7) -> None:
    import jax
    import jax.numpy as jnp

    from tpuslam.common.camera import Camera
    from tpuslam.config.schema import SlamConfig
    from tpuslam.frontend import detector as det_mod
    from tpuslam.model.slam import SlamPipeline

    frames = jax.device_put(ping_pong(fixture_frames(), n_frames))
    chunks = frames.reshape(-1, batch, *frames.shape[1:])
    valid = jnp.ones(chunks.shape[:2], bool)
    camera = Camera.from_yaml(REPO_ROOT / "configs" / "camera.yml")
    config = SlamConfig.from_yaml_dir(REPO_ROOT / "configs", batch_size=batch)
    c = config.detector
    args = dict(threshold=c.intensity_threshold, contiguous=c.contiguous_pixels_threshold)

    # Each pipeline is traced while its frontend is in place; the plain
    # variant calls the reference directly.
    kernel_frontend = det_mod.blur_fast_batch
    variants = {}
    for name, frontend in (
        ("triton", kernel_frontend),
        ("xla", det_mod.blur_fast_reference),
    ):
        det_mod.blur_fast_batch = frontend
        try:
            pipe = SlamPipeline(camera, config)
            state = pipe.initial_state()

            def dispatch(seed, pipe=pipe, state=state):
                keys = jax.random.split(jax.random.PRNGKey(seed), chunks.shape[0])
                return pipe._sequence_fn(chunks, valid, state, keys)

            t0 = time.perf_counter()
            jax.block_until_ready(dispatch(0))
            log(f"[ab] {name}: VO program compiled + first run {time.perf_counter() - t0:.1f} s")
            variants[name] = dispatch
        finally:
            det_mod.blur_fast_batch = kernel_frontend

    fps: dict[str, list[float]] = {"triton": [], "xla": []}
    for name in ("triton", "xla", "xla", "triton"):
        times = []
        for seed in range(1, reps + 1):
            t0 = time.perf_counter()
            jax.block_until_ready(variants[name](seed))
            times.append(time.perf_counter() - t0)
        fps[name].append(n_frames / statistics.median(times))
        log(f"[ab] VO {name}: {fps[name][-1]:.2f} frames/s (median of {reps} dispatches)")
    log(f"[ab] VO frames/s, A/B/B/A: {json.dumps(fps)}")

    from tpuslam.kernels.frontend_triton import fused_frontend_batch

    one = chunks[0]
    kern = jax.jit(partial(fused_frontend_batch, **args))
    plain = jax.jit(partial(det_mod.blur_fast_reference, **args))
    for i, (name, fn) in enumerate(
        (("triton", kern), ("xla", plain), ("xla", plain), ("triton", kern))
    ):
        log(
            f"[ab] blur+FAST {name} (16x512x1392): wall {wall_ms(fn, (one,), 50):.4f} ms, "
            f"device {device_ms(fn, (one,), 20, work, f'frontend_{i}_{name}'):.4f} ms"
        )
    stage_device_times(work, one, config)


def stage_device_times(work: Path, frames, config) -> None:
    """Trace device time of the stages that stay in XLA on the GPU, each
    through the function the pipeline calls, on one chunk's real keypoints."""
    import jax
    import jax.numpy as jnp

    from tpuslam.common.camera import Camera
    from tpuslam.frontend import pose
    from tpuslam.frontend.brief import (
        extract_brief_patches_i8, orientations_from_patches, quantized_brief_from_patches,
    )
    from tpuslam.frontend.detector import FeatureDetector, blur_fast_batch
    from tpuslam.frontend.fast import select_keypoints

    c = config.detector
    det = FeatureDetector(c)
    blur, corner, score = jax.jit(
        partial(blur_fast_batch, threshold=c.intensity_threshold,
                contiguous=c.contiguous_pixels_threshold)
    )(frames)
    kps = jax.jit(jax.vmap(partial(
        select_keypoints, nms=c.non_max_suppression, window=c.suppression_window_size,
        max_keypoints=c.max_keypoints,
    )))(corner, score)
    shape = blur.shape[1:]
    patches = jax.jit(jax.vmap(partial(extract_brief_patches_i8, patch_size=c.patch_size)))
    p = patches(blur, kps)
    angles = jax.jit(jax.vmap(lambda pp, k: orientations_from_patches(
        pp, det.moment_weights, k, c.patch_size, shape)))
    a = angles(p, kps)
    own_bin = jax.jit(jax.vmap(lambda pp, k, aa: quantized_brief_from_patches(
        pp, k, aa, det.pattern, det.bin_weights, c.num_brief_pairs, c.patch_size,
        c.brief_quantized_bins, shape,
    )))
    describe = jax.jit(jax.vmap(det._describe))
    # MSAC on matches shaped as the pipeline's: M = max_keypoints normalised
    # points, half of them valid, against num_hypotheses models.
    h, m, b = config.pose.num_hypotheses, c.max_keypoints, frames.shape[0]
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    e = jax.random.normal(k1, (b, h, 3, 3))
    x1 = jax.random.uniform(k2, (b, m, 2), minval=-0.5, maxval=0.5)
    x2 = x1 + 0.01 * jax.random.normal(k3, (b, m, 2))
    valid = jnp.broadcast_to(jnp.arange(m) < m // 2, (b, m))
    camera = Camera.from_yaml(REPO_ROOT / "configs" / "camera.yml")
    thr = (config.pose.inlier_threshold_px / (0.5 * (camera.fx + camera.fy))) ** 2
    msac = jax.jit(jax.vmap(partial(pose.msac_scores, thr=thr)))
    for name, fn, args in (
        (f"patch gather (16 x {m} patches)", patches, (blur, kps)),
        ("orientation moments", angles, (p, kps)),
        (f"own-bin BRIEF dots ({c.brief_quantized_bins} bins)", own_bin, (p, kps, a)),
        ("describe (gather + orientation + own-bin BRIEF)", describe, (blur, kps)),
        (f"MSAC scoring (16 x {h} x {m})", msac, (e, x1, x2, valid)),
    ):
        log(f"[ab] {name}: device {device_ms(fn, args, 20, work, name.split()[0]):.4f} ms per chunk")


# --- four devices ----------------------------------------------------------------
def phase_multidevice(work: Path, n_dev: int, n_frames: int = 96) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpuslam.common.camera import Camera
    from tpuslam.config.schema import SlamConfig
    from tpuslam.dist.mesh import make_device_mesh, sequence_sharding, shard_sequence_program
    from tpuslam.model.system import SlamSystem
    from tpuslam.post.trajectory import ate_rmse

    batch = 16
    camera = Camera.from_yaml(REPO_ROOT / "configs" / "camera.yml")
    config = SlamConfig.from_yaml_dir(REPO_ROOT / "configs", batch_size=batch)
    system = SlamSystem(
        camera, config, vocabulary=REPO_ROOT / "configs" / "vocabulary_tree.npz",
        tracking="pnp",
    )
    base = fixture_frames()
    # each sequence starts at another point of the ping-pong path
    seqs = np.stack([ping_pong(np.roll(base, -2 * s, axis=0), n_frames) for s in range(n_dev)])
    n_chunks = n_frames // batch
    chunks = seqs.reshape(n_dev, n_chunks, batch, *base.shape[1:])
    valid = jnp.ones((n_dev, n_chunks, batch), bool)
    db = system.loop_closure.new_db(
        config.detector.max_keypoints, config.detector.descriptor_bytes
    )
    carry0 = (system.pipeline.initial_pnp_state(), db, jnp.asarray(0, jnp.int32))
    keys = jax.vmap(lambda k: jax.random.split(k, n_chunks))(
        jax.random.split(jax.random.PRNGKey(0), n_dev)
    )

    mesh = make_device_mesh(n_dev)
    sh = sequence_sharding(mesh)
    step = shard_sequence_program(system._sequence_impl, mesh)
    carry_s = jax.tree.map(lambda a: jnp.broadcast_to(a, (n_dev, *a.shape)), carry0)
    t0 = time.perf_counter()
    _, outs = step(jax.device_put(chunks, sh), valid, carry_s, keys)
    sharded = np.asarray(outs["poses"]).reshape(n_dev, -1, 4, 4)
    log(f"[multi] multiseq S={n_dev} over {n_dev} GPUs: {time.perf_counter() - t0:.1f} s incl. compile")
    for s in range(n_dev):
        _, o1 = system._sequence_jit(jnp.asarray(chunks[s]), valid[s], carry0, keys[s])
        single = np.asarray(o1["poses"]).reshape(-1, 4, 4)
        ate, path = ate_rmse(sharded[s], single), path_length(single)
        log(f"[multi] sequence {s}: sharded vs one-device ATE {ate:.5f} over path {path:.3f}")
        if ate >= TRAJ_ATE_SHARE * path:
            raise AssertionError(f"multiseq sequence {s} departs from its one-device run")

    # --timeshard over a 40-frame ping-pong clip written as a PNG directory
    clip_dir = work / "clip"
    clip_dir.mkdir()
    for i, src in enumerate(ping_pong(sorted(IMAGES.glob("*.png")), 40)):
        shutil.copyfile(src, clip_dir / f"{i:06d}.png")
    cli = load_cli()
    out = work / "timeshard.txt"
    stats = run_cli(cli, [
        "-c", str(REPO_ROOT / "configs"), "-v", str(clip_dir), "-o", str(out),
        "--batch-size", "5", "--timeshard", str(n_dev), "--stats",
    ])
    log(f"[multi] timeshard {n_dev}: {json.dumps(stats)}")
    from tpuslam.model.slam import SlamPipeline
    from tpuslam.pre.stream import FrameStream

    cfg5 = SlamConfig.from_yaml_dir(REPO_ROOT / "configs", batch_size=5)
    single = SlamPipeline(camera, cfg5).run(FrameStream(clip_dir).batches(5), seed=0)["poses"]
    stitched = np.loadtxt(out).reshape(-1, 3, 4)
    ate, path = ate_rmse(stitched, single), path_length(single)
    log(f"[multi] timeshard vs one-device VO: ATE {ate:.5f} over path {path:.3f}")
    if ate >= TIMESHARD_ATE_SHARE * max(path, 1.0):
        raise AssertionError("time-sharded trajectory departs from the one-device run")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ab", action="store_true",
                        help="also time the Triton frontend against the plain path")
    parser.add_argument("--devices", type=int, default=1, choices=(1, 4),
                        help="4: run only the four-GPU paths")
    args = parser.parse_args(argv)

    sys.path.insert(0, str(REPO_ROOT))
    device = {"platform": None, "kind": None, "count": 0}
    ok = False
    try:
        from tpuslam.utils.platform import apply_env_platform

        apply_env_platform()
        import jax

        devs = jax.devices()
        device = {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}
        log(card_line())
        phase_device(args.devices)
        with tempfile.TemporaryDirectory(prefix="tpuslam_smoke_") as tmp:
            work = Path(tmp)
            if args.devices > 1:
                phase_multidevice(work, args.devices)
            else:
                for name, phase in (
                    ("kernel", phase_kernel),
                    ("main", partial(phase_main, work)),
                    *((("ab", partial(phase_ab, work)),) if args.ab else ()),
                ):
                    t0 = time.perf_counter()
                    phase()
                    log(f"[{name}] passed in {time.perf_counter() - t0:.1f} s")
        ok = True
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
    print(json.dumps({"ok": ok, "device": device}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
