"""Differential per-stage timing of the full SLAM sequence program.

The SLAM chunk program (tracking + map association + loop closure + BA +
relocalization, ``SlamSystem._sequence_impl``) is one fused XLA program —
individual stages can't be timed in place.  Instead, time the WHOLE staged
sequence program (the ``bench.py --slam`` protocol: frames pre-staged on
device, fresh PRNG keys on the timed dispatch) for a ladder of system
configurations, each disabling one stage; consecutive differences are the
marginal cost of that stage *inside the fused program* (which is what
matters — standalone stage timings miss fusion effects).

Usage (on the GPU): ``python tools/profile_slam.py [--pnp]``
(``--pnp`` ladders the map-centric PnP-SLAM composition instead.)
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

from tpuslam.utils.platform import apply_env_platform  # noqa: E402

apply_env_platform()

import numpy as np  # noqa: E402

BATCH = 16
N_FRAMES = 96


def _timed_fps(system, chunks_d, chunk_valid, carry0, n_chunks) -> float:
    import jax

    def keys_for(seed):
        return jax.vmap(
            lambda c: jax.random.fold_in(jax.random.PRNGKey(seed), c)
        )(jax.numpy.arange(n_chunks, dtype=jax.numpy.int32))

    _, outs = system._sequence_jit(chunks_d, chunk_valid, carry0, keys_for(0))
    jax.block_until_ready(outs["poses"])  # compile + warm
    # Median of 3 fresh-keys dispatches: single-dispatch wall clocks vary
    # enough to flip a ladder row's sign.
    times = []
    for seed in (1, 2, 3):
        t0 = time.perf_counter()
        _, outs = system._sequence_jit(
            chunks_d, chunk_valid, carry0, keys_for(seed)
        )
        jax.block_until_ready(outs["poses"])
        times.append(time.perf_counter() - t0)
    return N_FRAMES / sorted(times)[1]


def main() -> None:
    import jax
    import jax.numpy as jnp

    from tpuslam.backend.map import empty_assoc, empty_map
    from tpuslam.common.camera import Camera
    from tpuslam.config.schema import SlamConfig
    from tpuslam.model.system import SlamSystem
    from tpuslam.pre.stream import FrameStream

    stream = FrameStream(REPO_ROOT / "tests" / "data" / "images")
    base = [stream.read_frame(i)[0] for i in range(stream.total_frames)]
    # Ping-pong tiling — continuous camera path, matching bench.py (the
    # old `i % 10` wrap teleported every cycle and fired relocalization).
    period = 2 * (len(base) - 1)
    idx = [min(i % period, period - i % period) for i in range(N_FRAMES)]
    frames = np.stack([base[i] for i in idx])
    frames_d = jax.device_put(frames)
    jax.block_until_ready(frames_d)
    chunks_d = frames_d.reshape(-1, BATCH, *frames_d.shape[1:])
    n_chunks = chunks_d.shape[0]
    chunk_valid = jnp.ones((n_chunks, BATCH), bool)

    camera = Camera.from_yaml(REPO_ROOT / "configs" / "camera.yml")
    config = SlamConfig.from_yaml_dir(REPO_ROOT / "configs", batch_size=BATCH)

    pnp = "--pnp" in sys.argv
    # Ladder: each row disables ONE more stage than the previous; the FPS
    # delta between consecutive rows is that stage's marginal cost.
    if pnp:
        ladder = [
            ("full pnp-slam", {}),
            ("- loop closure", {"enable_loop_closure": False}),
            ("- BA", {"enable_loop_closure": False, "enable_ba": False}),
        ]
    else:
        ladder = [
            ("full system", {}),
            ("- relocalization", {"enable_relocalization": False}),
            ("- loop closure", {"enable_relocalization": False,
                                "enable_loop_closure": False}),
            ("- BA", {"enable_relocalization": False,
                      "enable_loop_closure": False, "enable_ba": False}),
        ]
    prev_ms = None
    for name, kw in ladder:
        system = SlamSystem(
            camera, config,
            vocabulary=(REPO_ROOT / "configs" / "vocabulary.npz"
                        if kw.get("enable_loop_closure", True) else None),
            tracking="pnp" if pnp else "vo",
            **kw,
        )
        db = (
            system.loop_closure.new_db(
                config.detector.max_keypoints, config.detector.descriptor_bytes
            )
            if system.loop_closure is not None
            else jnp.zeros(())
        )
        if pnp:
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
        fps = _timed_fps(system, chunks_d, chunk_valid, carry0, n_chunks)
        ms_per_chunk = 1000.0 * BATCH / fps
        delta = "" if prev_ms is None else (
            f"   (stage cost {prev_ms - ms_per_chunk:+.2f} ms/chunk)"
        )
        print(f"{name:<20} {fps:7.1f} FPS   {ms_per_chunk:6.2f} ms/chunk{delta}")
        prev_ms = ms_per_chunk


if __name__ == "__main__":
    main()
