#!/usr/bin/env python
"""Throughput benchmark: monocular VO/SLAM frames per second on one GPU.

Protocol: the 10 KITTI fixture frames (1392×512 grayscale) are tiled to a
96-frame ping-pong clip and pushed through the full jitted pipeline —
undistortion, FAST+NMS (1024-keypoint capacity), steered BRIEF,
brute-force Hamming matching with ratio test, batched-RANSAC essential
matrix, cheirality pose recovery, and trajectory composition (plus map,
loop closure and BA in the SLAM modes).  Frames are staged on the device
first; compilation is excluded (one warm-up dispatch per program); each
number is the median of 7 dispatches, each ended by ``block_until_ready``
and each with fresh PRNG keys.

``python bench.py`` runs every mode; ``--vo-only``, ``--slam [--pnp]``,
``--pnp``, ``--multiseq``, ``--fast``, ``--pyramid`` and ``--localize`` run
one.  Every JSON line carries the device (platform, kind, count) and the
card's power limit; a run whose JAX device is not a GPU fails.

Process architecture: the combined run is an orchestrator that never
starts a JAX backend.  Each mode runs in its own sequential child process,
so one process at a time holds the card (a second JAX process would fail
to reserve its memory), and the merged record is re-printed after every
mode: the last JSON line on stdout is always the most complete one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO_ROOT))

import numpy as np  # noqa: E402

BATCH = 16
N_FRAMES = 96


def power_limit() -> str:
    """The first card's power limit as nvidia-smi reports it."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def device_info() -> dict:
    """JAX's devices; raises unless they are GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"bench.py measures the GPU; JAX's device is {devs[0].platform!r}"
        )
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def _vocab():
    """Production vocabulary: the hierarchical tree (thresholds in
    configs/loop_closure.yml are calibrated for it); flat fallback."""
    tree = REPO_ROOT / "configs" / "vocabulary_tree.npz"
    return tree if tree.is_file() else REPO_ROOT / "configs" / "vocabulary.npz"


def _load_frames(n_frames: int) -> np.ndarray:
    from tpuslam.pre.stream import FrameStream

    stream = FrameStream(REPO_ROOT / "tests" / "data" / "images")
    base = [stream.read_frame(i)[0] for i in range(stream.total_frames)]
    # Ping-pong tiling (0..9,8..1,0..9,…): a CONTINUOUS camera path, not
    # the old `i % 10` wrap whose frame-9→frame-0 teleports lose tracking
    # every cycle.  VO timing is shape-dominated and unaffected; SLAM mode
    # is content-sensitive now that lost frames trigger real relocalization
    # work (the wrap teleports fired reloc on most chunks, turning the
    # steady-state benchmark into a worst-case relocalization benchmark).  Reverse traversal is ordinary backward
    # camera motion — trackable, and a fair stand-in for a loopy sequence.
    period = 2 * (len(base) - 1)
    idx = [min(i % period, period - i % period) for i in range(n_frames)]
    return np.stack([base[i] for i in idx])


def _staged(frames: np.ndarray):
    import jax

    frames_d = jax.device_put(frames)
    jax.block_until_ready(frames_d)
    return frames_d


def _median_fps(dispatch, n_frames: int, seeds=(1, 2, 3, 4, 5, 6, 7)) -> float:
    """Frames/s from the median of several timed dispatches.

    Each dispatch ends in ``block_until_ready`` and uses its own PRNG seed
    at an identical program shape.
    """
    times = []
    for seed in seeds:
        t0 = time.perf_counter()
        dispatch(seed)
        times.append(time.perf_counter() - t0)
    return n_frames / sorted(times)[len(times) // 2]


def measure_vo(frames_d, config_dir: str = "configs", tracking: str = "vo") -> float:
    """One-dispatch VO (or PnP) tracking over the staged sequence."""
    import jax

    from tpuslam.common.camera import Camera
    from tpuslam.config.schema import SlamConfig
    from tpuslam.model.slam import SlamPipeline

    camera = Camera.from_yaml(REPO_ROOT / config_dir / "camera.yml")
    config = SlamConfig.from_yaml_dir(REPO_ROOT / config_dir, batch_size=BATCH)
    pipeline = SlamPipeline(camera, config, tracking=tracking)
    if tracking == "pnp":
        state, fn = pipeline.initial_pnp_state(), pipeline._sequence_pnp_fn
    else:
        state, fn = pipeline.initial_state(), pipeline._sequence_fn
    chunks_d = frames_d.reshape(-1, BATCH, *frames_d.shape[1:])
    chunk_valid = jax.numpy.ones((chunks_d.shape[0], BATCH), bool)

    def dispatch(seed):
        keys = jax.random.split(jax.random.PRNGKey(seed), chunks_d.shape[0])
        jax.block_until_ready(fn(chunks_d, chunk_valid, state, keys))

    dispatch(0)  # compile + warm
    return _median_fps(dispatch, N_FRAMES)


def measure_slam(frames_d, tracking: str = "vo") -> float:
    """Full SLAM system: tracking + map association + loop closure + BA.

    ``tracking="pnp"`` times the map-centric composition (PnP tracking
    against the shared BA-optimised map — the reference's declared
    Backend/Map architecture, ``backend.hpp:13-17`` + ``map.hpp:9-21``).
    The one-dispatch sequence program (``SlamSystem._sequence_jit``) is
    timed directly on pre-staged device chunks; the streaming ``run()``
    driver adds host-side decode and trajectory folding.
    """
    import jax
    import jax.numpy as jnp

    from tpuslam.backend.map import empty_assoc, empty_map
    from tpuslam.common.camera import Camera
    from tpuslam.config.schema import SlamConfig
    from tpuslam.model.system import SlamSystem

    camera = Camera.from_yaml(REPO_ROOT / "configs" / "camera.yml")
    config = SlamConfig.from_yaml_dir(REPO_ROOT / "configs", batch_size=BATCH)
    system = SlamSystem(camera, config, vocabulary=_vocab(), tracking=tracking)
    chunks_d = frames_d.reshape(-1, BATCH, *frames_d.shape[1:])
    n_chunks = chunks_d.shape[0]
    chunk_valid = jnp.ones((n_chunks, BATCH), bool)
    db = system.loop_closure.new_db(
        config.detector.max_keypoints, config.detector.descriptor_bytes
    )
    if tracking == "pnp":
        carry0 = (
            system.pipeline.initial_pnp_state(),
            db,
            jnp.asarray(0, jnp.int32),
        )
    else:
        carry0 = (
            system.pipeline.initial_state(),
            empty_map(system.ba_window, system.max_map_points),
            empty_assoc(config.detector.max_keypoints),
            db,
            jnp.asarray(0, jnp.int32),
        )

    def dispatch(seed):
        keys = jax.vmap(
            lambda c: jax.random.fold_in(jax.random.PRNGKey(seed), c)
        )(jnp.arange(n_chunks, dtype=jnp.int32))
        _, outs = system._sequence_jit(chunks_d, chunk_valid, carry0, keys)
        jax.block_until_ready(outs["poses"])

    dispatch(0)  # compile + warm
    return _median_fps(dispatch, N_FRAMES)


def measure_multiseq(frames: np.ndarray) -> tuple[float, int]:
    """Multi-sequence SLAM throughput (BASELINE config 5).

    One full PnP-SLAM sequence program per device, the sequence axis
    sharded over a mesh of every visible GPU (``dist/mesh.py``); on one
    GPU this is S=1.  Aggregate frames/s across all sequences.
    """
    import jax
    import jax.numpy as jnp

    from tpuslam.common.camera import Camera
    from tpuslam.config.schema import SlamConfig
    from tpuslam.dist.mesh import (
        make_device_mesh,
        sequence_sharding,
        shard_sequence_program,
    )
    from tpuslam.model.system import SlamSystem

    S = len(jax.devices())
    mesh = make_device_mesh(S)
    sh = sequence_sharding(mesh)

    camera = Camera.from_yaml(REPO_ROOT / "configs" / "camera.yml")
    config = SlamConfig.from_yaml_dir(REPO_ROOT / "configs", batch_size=BATCH)
    system = SlamSystem(camera, config, vocabulary=_vocab(), tracking="pnp")
    n_chunks = N_FRAMES // BATCH
    chunks = frames.reshape(1, n_chunks, BATCH, *frames.shape[1:])
    chunks_d = jax.device_put(
        jnp.broadcast_to(jnp.asarray(chunks), (S, *chunks.shape[1:])), sh
    )
    chunk_valid = jnp.ones((S, n_chunks, BATCH), bool)
    db = system.loop_closure.new_db(
        config.detector.max_keypoints, config.detector.descriptor_bytes
    )
    carry0 = (
        system.pipeline.initial_pnp_state(),
        db,
        jnp.asarray(0, jnp.int32),
    )
    carry_s = jax.tree.map(lambda a: jnp.broadcast_to(a, (S, *a.shape)), carry0)

    # shard_map, not vmap: each sequence runs the unbatched program on its
    # own device, so the chunk-level lax.conds (LC verification skip, PnP's
    # RANSAC fallback) stay real branches instead of both-branch selects.
    step = shard_sequence_program(system._sequence_impl, mesh)

    def dispatch(seed):
        base = jax.random.split(jax.random.PRNGKey(seed), S)
        keys = jax.vmap(lambda k: jax.random.split(k, n_chunks))(base)
        _, outs = step(chunks_d, chunk_valid, carry_s, keys)
        jax.block_until_ready(outs["poses"])

    dispatch(0)  # compile + warm
    return _median_fps(dispatch, S * N_FRAMES), S


def measure_localization() -> dict:
    """Localization-only mode: track a frozen, checkpointed map.

    One untimed mapping pass over the 96-frame clip builds the map+DB; the
    frozen-map localization sequence program is then timed over a 96-frame
    and a 192-frame staged clip (same ping-pong tiling — the longer clip
    stays inside mapped territory), and the steady-state number is the
    marginal rate (192−96)/(t₁₉₂−t₉₆), which cancels the one-time bootstrap
    lock-in that dominates short-clip averages.
    """
    import jax
    import jax.numpy as jnp

    from tpuslam.common.camera import Camera
    from tpuslam.config.schema import SlamConfig
    from tpuslam.model.system import SlamSystem

    camera = Camera.from_yaml(REPO_ROOT / "configs" / "camera.yml")
    config = SlamConfig.from_yaml_dir(REPO_ROOT / "configs", batch_size=BATCH)
    frames96 = _load_frames(N_FRAMES)
    frames192 = _load_frames(2 * N_FRAMES)

    mapper = SlamSystem(
        camera, config, vocabulary=_vocab(), tracking="pnp",
        enable_pose_graph=False,
    )
    out = mapper.run_sequence(frames96, seed=0)

    loc = SlamSystem(
        camera, config, vocabulary=_vocab(), tracking="pnp",
        localization_only=True, enable_pose_graph=False,
    )
    carry0 = (
        loc.pipeline.initial_pnp_state()._replace(map=out["map"]),
        out["db"],
        jnp.asarray(0, jnp.int32),
    )

    def timed(frames):
        chunks_d = _staged(frames).reshape(-1, BATCH, *frames.shape[1:])
        n_chunks = chunks_d.shape[0]
        chunk_valid = jnp.ones((n_chunks, BATCH), bool)

        def dispatch(seed):
            keys = jax.vmap(
                lambda c: jax.random.fold_in(jax.random.PRNGKey(seed), c)
            )(jnp.arange(n_chunks, dtype=jnp.int32))
            _, outs = loc._sequence_jit(chunks_d, chunk_valid, carry0, keys)
            jax.block_until_ready(outs["poses"])

        dispatch(0)  # compile + warm
        return len(frames) / _median_fps(dispatch, len(frames))

    t96 = timed(frames96)
    t192 = timed(frames192)
    marginal = N_FRAMES / max(t192 - t96, 1e-9)
    return {
        "metric": "localization_throughput_kitti",
        "value": round(marginal, 2),
        "unit": "frames/sec",
        "from_scratch_96f": round(N_FRAMES / t96, 2),
    }


# mode flag → (record key in the combined run, metric name)
MODES = {
    "--vo-only": (None, "vo_throughput_kitti"),
    "--slam": ("slam_fps", "slam_throughput_kitti"),
    "--pnp": ("pnp_fps", "pnp_throughput_kitti"),
    "--slam --pnp": ("slam_pnp_fps", "slam_pnp_throughput_kitti"),
    "--multiseq": ("multiseq_fps", "multiseq_slam_throughput_kitti"),
    "--fast": ("fast_fps", "vo_fast_throughput_kitti"),
    "--pyramid": ("pyramid_fps", "vo_pyramid_throughput_kitti"),
    "--localize": ("localization_fps", "localization_throughput_kitti"),
}


def run_mode(flags: list[str]) -> dict:
    """Measure one mode in this process and return its record."""
    from tpuslam.utils.platform import apply_env_platform

    apply_env_platform()
    device = device_info()
    mode = " ".join(f for f in ("--slam", "--pnp", "--multiseq", "--fast",
                                "--pyramid", "--localize") if f in flags)
    if mode == "--localize":
        record = measure_localization()
    else:
        frames = _load_frames(N_FRAMES)
        extra = {}
        if mode == "--slam":
            fps = measure_slam(_staged(frames))
        elif mode == "--slam --pnp":
            fps = measure_slam(_staged(frames), tracking="pnp")
        elif mode == "--pnp":
            fps = measure_vo(_staged(frames), tracking="pnp")
        elif mode == "--multiseq":
            fps, extra["sequences"] = measure_multiseq(frames)
        elif mode == "--fast":
            # Halved RANSAC hypothesis budget (configs/fast): the
            # high-inlier continuous-video profile.
            fps = measure_vo(_staged(frames), config_dir="configs/fast")
        elif mode == "--pyramid":
            # 4-level ORB-style pyramid profile (configs/multiscale).
            fps = measure_vo(_staged(frames), config_dir="configs/multiscale")
        else:
            mode = "--vo-only"
            fps = measure_vo(_staged(frames))
        record = {
            "metric": MODES[mode][1],
            "value": round(fps, 2),
            "unit": "frames/sec",
            **extra,
        }
    return {**record, "device": device, "power_limit": power_limit()}


def main() -> None:
    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    if flags:
        print(json.dumps(run_mode(flags)), flush=True)
        return
    orchestrate()


def _env_float(name: str, default: float) -> float:
    """Defensive env parse: a malformed value must not kill the run."""
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _run_mode(args: list[str], timeout_s: float) -> dict | None:
    """Run one bench mode as a child process; parse its JSON line.

    The child holds the card alone while it runs and releases it when it
    exits, even when it is killed at its time limit.
    """
    cmd = [sys.executable, str(REPO_ROOT / "bench.py"), *args]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=timeout_s
        )
    except subprocess.TimeoutExpired:
        return None
    sys.stderr.write(proc.stderr[-4000:])
    for line in reversed((proc.stdout or "").strip().splitlines()):
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "value" in rec:
            return rec
    return None


def orchestrate() -> None:
    """Combined run: every mode in its own timed child process.

    The merged record is (re-)printed after each mode, so the LAST JSON
    line on stdout is always the most complete record even if this
    process is killed mid-run.  Per-mode time limit ``BENCH_MODE_BUDGET_S``
    (default 420 s: cold compiles of the full-SLAM programs take minutes),
    total ``BENCH_BUDGET_S`` (default 3600 s), one retry per mode while
    the total budget remains.  This process never starts a JAX backend.
    """
    budget_s = _env_float("BENCH_BUDGET_S", 3600.0)
    per_mode_s = _env_float("BENCH_MODE_BUDGET_S", 420.0)
    t0 = time.monotonic()
    # value appears only once the vo child actually reports: a skipped
    # headline must be distinguishable from a measured 0.0 regression.
    record: dict = {
        "metric": "vo_throughput_kitti",
        "unit": "frames/sec",
        "power_limit": power_limit(),
    }
    skipped = []
    for flags, (key, _) in MODES.items():
        rec = None
        for attempt in (1, 2):
            remaining = budget_s - (time.monotonic() - t0)
            if remaining < 30:
                break
            print(f"[bench] {key or 'vo'} attempt {attempt} "
                  f"({remaining:.0f}s left)", file=sys.stderr, flush=True)
            rec = _run_mode(flags.split(), min(per_mode_s, remaining))
            if rec is not None:
                break
        if rec is None:
            skipped.append(key or "vo")
        elif key is None:
            record.update(rec)
        else:
            record[key] = rec["value"]
            record.setdefault("device", rec["device"])
            if "from_scratch_96f" in rec:
                record["localization_from_scratch_96f"] = rec["from_scratch_96f"]
        if skipped:
            record["skipped"] = (
                f"{'+'.join(skipped)}: mode failed, timed out or budget exhausted"
            )
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
