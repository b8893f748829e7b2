#!/usr/bin/env python
"""tpuslam CLI — run monocular VO/SLAM over an image directory or video.

Same surface as the reference CLI (``tools/cli/cli.cpp:10-38``):
``-c <config> -v <stream> [-h]``, extended with an output path and frame
controls.  Unlike the reference (whose ``SLAMModel::run()`` was never
implemented), this actually runs the pipeline and writes a KITTI-format
trajectory.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from tpuslam.utils.platform import apply_env_platform  # noqa: E402

apply_env_platform()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpuslam",
        description="Monocular visual SLAM in JAX",
    )
    parser.add_argument("-c", "--config", required=True,
                        help="config directory holding camera.yml, feature_detector.yml, ...")
    parser.add_argument("-v", "--stream", required=True,
                        help="image directory (with timestamps.txt) or video file")
    parser.add_argument("-o", "--output", default="trajectory.txt",
                        help="output trajectory path (KITTI 12-value rows)")
    parser.add_argument("--camera-index", type=int, default=0)
    parser.add_argument("--frame-skip", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--max-frames", type=int, default=0,
                        help="stop after this many frames (0 = all)")
    parser.add_argument("--stats", action="store_true",
                        help="print per-run stats as JSON")
    parser.add_argument("--slam", action="store_true",
                        help="full SLAM mode: keyframes + windowed bundle "
                             "adjustment + loop closure (needs a vocabulary)")
    parser.add_argument("--tracking", choices=("vo", "pnp"), default="vo",
                        help="'vo' chains scaled two-view poses; 'pnp' tracks "
                             "each frame absolutely against the persistent "
                             "landmark map (RANSAC DLT-PnP)")
    parser.add_argument("--vocabulary", default=None,
                        help="BoW vocabulary .npz (default: the config "
                             "directory's vocabulary_tree.npz if present — "
                             "the production hierarchical vocabulary — else "
                             "vocabulary.npz)")
    parser.add_argument("--save-state", default=None,
                        help="write final map/trajectory checkpoint (.npz)")
    parser.add_argument("--resume", default=None,
                        help="resume from a --save-state checkpoint: restores "
                             "the tracking state (plus map/keyframe-DB/BA/"
                             "loop state in --slam mode) and continues the "
                             "stream at the saved frame index; the result is "
                             "identical to an uninterrupted run at the same "
                             "batch size")
    parser.add_argument("--timeshard", type=int, default=0, metavar="N",
                        help="cut the video's time axis into N overlapping "
                             "segments tracked in parallel across the device "
                             "mesh, stitched by Sim(3) over the overlaps "
                             "(VO tracking only; N must not exceed the "
                             "device count)")
    parser.add_argument("--localize", default=None, metavar="CKPT",
                        help="localization-only mode: load the map + "
                             "keyframe DB from a --save-state checkpoint "
                             "of a --slam --tracking pnp run and track the "
                             "stream against them FROZEN (no inserts, no "
                             "BA); an unknown start pose bootstraps by "
                             "relocalization against the loaded DB")
    parser.add_argument("--plot", default=None,
                        help="write a top-down trajectory plot PNG")
    parser.add_argument("--debug", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format="[%(asctime)s] [%(levelname)s] %(message)s",
    )
    log = logging.getLogger("tpuslam")

    from tpuslam.common.camera import Camera
    from tpuslam.config.schema import SlamConfig
    from tpuslam.model.slam import SlamPipeline
    from tpuslam.post.trajectory import save_kitti_trajectory
    from tpuslam.pre.stream import FrameStream

    cfg_dir = Path(args.config)

    def default_vocab():
        # Production default: the hierarchical tree vocabulary (fbow-scale
        # retrieval, thresholds calibrated for it in loop_closure.yml);
        # flat vocabulary.npz remains the fixture-scale fallback.
        tree = cfg_dir / "vocabulary_tree.npz"
        return tree if tree.is_file() else cfg_dir / "vocabulary.npz"

    camera = Camera.from_yaml(cfg_dir / "camera.yml", camera_index=args.camera_index)
    config = SlamConfig.from_yaml_dir(
        cfg_dir, frame_skip=args.frame_skip, batch_size=args.batch_size
    )
    if args.localize:
        if args.slam or args.resume or args.save_state or args.timeshard:
            parser.error("--localize is its own mode (no --slam/--resume/"
                         "--save-state/--timeshard)")
        import numpy as np

        from tpuslam.model.system import SlamSystem
        from tpuslam.utils.checkpoint import load_state

        vocab = args.vocabulary or default_vocab()
        system = SlamSystem(
            camera, config, vocabulary=vocab, tracking="pnp",
            localization_only=True,
        )
        loaded = load_state(args.localize, slam=system.checkpoint_template())
        warm = {
            "map": loaded["slam"]["world_map"],
            "db": loaded["slam"]["db"],
        }
        stream = FrameStream(args.stream, frame_skip=args.frame_skip)
        log.info(
            "Localization-only (streaming): %s against the frozen map/DB "
            "of %s", args.stream, args.localize,
        )
        # Streaming driver, NOT an np.stack of the whole clip: the mode's
        # story is unbounded deployment against a frozen map, so host RSS
        # must stay flat (one chunk in flight at a time).
        batches = stream.batches(args.batch_size)
        if args.max_frames:
            def limited(it, limit=args.max_frames):
                seen = 0
                for frames_b, ts, valid in it:
                    yield frames_b, ts, valid
                    seen += int(valid.sum())
                    if seen >= limit:
                        break
            batches = limited(batches)
        t0 = time.time()
        res = system.run(batches, warm_start=warm)
        dt = time.time() - t0
        save_kitti_trajectory(res["poses"], args.output)
        log.info("Trajectory written to %s", args.output)
        if args.plot:
            from tpuslam.post.visualizer import plot_trajectory

            plot_trajectory(res["poses"], args.plot)
        if args.stats:
            n_loc = len(res["poses"])
            print(json.dumps({
                "frames": int(n_loc),
                "seconds": dt,
                "fps": n_loc / dt,
                "pose_ok": int(np.asarray(res["pose_ok"]).sum()),
                "relocalizations": int(np.asarray(res["reloc_ok"]).sum()),
            }))
        return 0

    if args.slam:
        from tpuslam.model.system import SlamSystem

        vocab = args.vocabulary or default_vocab()
        pipeline = SlamSystem(
            camera, config, vocabulary=vocab, tracking=args.tracking
        )
        log.info(
            "Full SLAM mode, %s tracking (vocabulary: %s)", args.tracking, vocab
        )
    else:
        pipeline = SlamPipeline(camera, config, tracking=args.tracking)
    stream = FrameStream(args.stream, frame_skip=args.frame_skip)
    log.info("Stream %s: %d frames", args.stream, stream.total_frames)

    if args.timeshard:
        if args.resume:
            parser.error("--timeshard does not support --resume")
        if args.save_state:
            parser.error("--timeshard does not checkpoint (--save-state); "
                         "per-shard state is not resumable")
        import numpy as np

        from tpuslam.dist.timeshard import run_timesharded, run_timesharded_system

        # frame_indices() honours --frame-skip (same frames every other
        # mode would process)
        indices = stream.frame_indices()
        if args.max_frames:
            indices = indices[: args.max_frames]
        n_total = len(indices)
        # Disk-backed staging: the video decodes once into a memmap and
        # each shard's window is sliced straight onto ITS device, so host
        # RSS stays ~one shard instead of 2× the whole video.
        from tpuslam.pre.stream import frames_to_memmap

        frames = frames_to_memmap(stream, indices)
        t0 = time.time()
        if args.slam:
            # full per-shard SLAM (map + LC + BA, VO or PnP tracking);
            # cross-segment loops are recovered by the host-side post-pass
            # + global pose graph (see run_timesharded_system)
            result = run_timesharded_system(
                pipeline, frames, n_shards=args.timeshard
            )
        else:
            if args.tracking != "vo":
                parser.error(
                    "--timeshard --tracking pnp requires --slam (the "
                    "map-centric tracker needs its per-shard map)"
                )
            result = run_timesharded(pipeline, frames, n_shards=args.timeshard)
        dt = time.time() - t0
        log.info(
            "Time-sharded %d frames over %d segments (S=%d, V=%d) in %.2fs",
            n_total, args.timeshard, result["S"], result["V"], dt,
        )
        save_kitti_trajectory(result["poses"], args.output)
        log.info("Trajectory written to %s", args.output)
        if args.plot:
            from tpuslam.post.visualizer import plot_trajectory

            plot_trajectory(result["poses"], args.plot)
        if args.stats:
            stats = {
                "frames": int(n_total),
                "seconds": dt,
                "fps": n_total / dt,
                "pose_ok": int(result["pose_ok"].sum()),
                "segments": int(args.timeshard),
            }
            if args.slam:
                stats["loops"] = len(result.get("loops", []))
                stats["ba_events"] = len(result.get("ba_events", []))
            print(json.dumps(stats))
        return 0

    resume_state = None
    resume_poses = None
    slam_resume = None
    start_frame = 0
    if args.resume:
        from tpuslam.utils.checkpoint import load_state

        import numpy as _np

        if args.slam:
            loaded = load_state(args.resume, slam=pipeline.checkpoint_template())
            slam_resume = loaded["slam"]
            start_frame = int(_np.asarray(slam_resume["counters"])[0])
        else:
            template = (
                pipeline.initial_pnp_state()
                if args.tracking == "pnp"
                else pipeline.initial_state()
            )
            loaded = load_state(
                args.resume, state=template, trajectory=_np.zeros((0, 4, 4))
            )
            resume_state = loaded["state"]
            resume_poses = _np.asarray(loaded["trajectory"])
            start_frame = len(resume_poses)
        log.info("Resuming at frame %d from %s", start_frame, args.resume)

    t0 = time.time()
    batches = stream.batches(args.batch_size, start_frame=start_frame)
    if args.max_frames:
        def limited(it, limit=args.max_frames):
            seen = 0
            for frames, ts, valid in it:
                yield frames, ts, valid
                seen += int(valid.sum())
                if seen >= limit:
                    break
        batches = limited(batches)
    if not args.slam and args.tracking == "pnp":
        result = pipeline.run_pnp(batches, initial_state=resume_state)
    elif not args.slam:
        result = pipeline.run(batches, initial_state=resume_state)
    else:
        # SLAM resume payloads already contain the prior trajectory; the
        # returned poses cover the whole run.
        result = pipeline.run(batches, resume=slam_resume)
    if resume_poses is not None:
        import numpy as _np

        result["poses"] = _np.concatenate([resume_poses, result["poses"]])
    dt = time.time() - t0
    n = len(result["poses"])
    log.info("Processed %d frames in %.2fs (%.1f FPS incl. compile)", n, dt, n / dt)

    save_kitti_trajectory(result["poses"], args.output)
    log.info("Trajectory written to %s", args.output)

    if args.slam and result.get("loops"):
        for lp in result["loops"]:
            log.info("Loop closure: frame %d -> keyframe %d (%d inliers)",
                     lp["frame_id"], lp["matched_keyframe_id"], lp["num_inliers"])
    if args.save_state:
        from tpuslam.utils.checkpoint import save_state

        if args.slam:
            states = {"slam": result["checkpoint"]}
        else:
            states = {"trajectory": result["poses"]}
            if "state" in result:
                states["state"] = result["state"]
        save_state(args.save_state, **states)
        log.info("State checkpoint written to %s", args.save_state)
    if args.plot:
        from tpuslam.post.visualizer import plot_trajectory

        plot_trajectory(result["poses"], args.plot)
        log.info("Trajectory plot written to %s", args.plot)

    if args.stats:
        stats = {
            "frames": n,
            "seconds": dt,
            "fps": n / dt,
            "pose_ok": int(result["pose_ok"].sum()),
            "mean_matches": float(result["num_matches"].mean()),
            "mean_inliers": float(result["num_inliers"].mean()),
        }
        if "reloc_ok" in result:
            stats["relocalizations"] = int(result["reloc_ok"].sum())
        print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
