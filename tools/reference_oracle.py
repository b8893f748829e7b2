#!/usr/bin/env python
"""Reference-numerics oracle trajectory (the ATE-parity baseline).

Building the C++ reference is impossible here (Conan, zero egress), but its
two-view estimator is exactly ``cv::findEssentialMat(RANSAC)`` plus a
~100-line ``simpleRecoverPose`` (``src/frontend/pose_estimator.cpp:18-67``,
``src/frontend/simple_pose_recover.cpp:35-97``) — both reproduced in
float64 NumPy/cv2 in ``tests/golden/reference_impl.py``.  This tool runs
the framework's frontend (detection/description/matching are bit-parity
tested against scalar reference oracles) and the *reference's* pose
numerics over a frame directory, chaining unit-baseline relative poses into
a trajectory — the stand-in for "what the C++ reference would output",
against which BASELINE.json's "ATE RMSE within 5%" is measured.

Usage:
  python tools/reference_oracle.py -c configs -v tests/data/images -o oracle.txt
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import numpy as np


def oracle_trajectory(
    stream_path: str | Path,
    config_dir: str | Path,
    max_frames: int = 0,
    camera_index: int = 0,
) -> np.ndarray:
    """(N, 4, 4) reference-numerics trajectory over a frame stream."""
    import jax.numpy as jnp

    from tests.golden.reference_impl import estimate_pose_ref
    from tpuslam.common.camera import Camera, undistort_image
    from tpuslam.config.schema import SlamConfig
    from tpuslam.frontend.detector import FeatureDetector
    from tpuslam.frontend.matcher import match_descriptors
    from tpuslam.pre.stream import FrameStream

    config_dir = Path(config_dir)
    camera = Camera.from_yaml(config_dir / "camera.yml", camera_index=camera_index)
    config = SlamConfig.from_yaml_dir(config_dir)
    detector = FeatureDetector(config.detector)
    idx, valid = camera.device_undistort_map()
    K = np.asarray(camera.K, np.float64)
    mcfg = config.matcher

    stream = FrameStream(stream_path)
    n = stream.total_frames if max_frames <= 0 else min(max_frames, stream.total_frames)

    poses = [np.eye(4)]
    prev = None
    for i in range(n):
        frame, _ = stream.read_frame(i)
        und = undistort_image(jnp.asarray(frame), idx, valid, normalize=False)
        kps, desc = detector.detect_and_compute(und)
        cur = (kps, desc)
        if prev is not None:
            kq, dq = prev
            kt, dt = cur
            match = match_descriptors(
                dq,
                dt,
                kq.valid,
                kt.valid,
                kq.xy,
                kt.xy,
                ratio_threshold=mcfg.ratio_test_threshold,
                max_jump_radius=mcfg.max_jump_radius,
                use_ratio_test=mcfg.use_ratio_test,
                filter_matches=False,
                use_spatial_penalty=True,
            )
            mv = np.asarray(match.valid)
            q = np.asarray(jnp.maximum(match.query_idx, 0))[mv]
            t_i = np.asarray(jnp.maximum(match.train_idx, 0))[mv]
            pts1 = np.asarray(kq.xy)[q]
            pts2 = np.asarray(kt.xy)[t_i]
            rt = estimate_pose_ref(pts1, pts2, K)
            if rt is None:
                T_rel = np.eye(4)
            else:
                R, t = rt
                T_rel = np.eye(4)
                T_rel[:3, :3] = R.T  # T_cam1_cam2
                T_rel[:3, 3] = -R.T @ t
            poses.append(poses[-1] @ T_rel)
        prev = cur
    return np.stack(poses[:n])


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Reference-numerics oracle trajectory")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-v", "--stream", required=True)
    parser.add_argument("-o", "--output", default="oracle_trajectory.txt")
    parser.add_argument("--max-frames", type=int, default=0)
    args = parser.parse_args(argv)

    from tpuslam.post.trajectory import save_kitti_trajectory

    poses = oracle_trajectory(args.stream, args.config, args.max_frames)
    save_kitti_trajectory(poses, args.output)
    print(f"oracle trajectory ({len(poses)} frames) -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
