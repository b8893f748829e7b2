#!/usr/bin/env python
"""Evaluate an estimated trajectory against ground truth (KITTI format).

ATE-RMSE after Sim(3) alignment (monocular scale freedom) and RPE — the
parity arbiters of BASELINE.json.

Usage:
  python tools/evaluate.py estimate.txt groundtruth.txt [--no-scale] [--plot out.png]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Trajectory evaluation (ATE/RPE)")
    parser.add_argument("estimate")
    parser.add_argument("groundtruth")
    parser.add_argument("--no-scale", action="store_true",
                        help="SE(3) alignment instead of Sim(3)")
    parser.add_argument("--rpe-delta", type=int, default=1)
    parser.add_argument("--plot", default=None)
    args = parser.parse_args(argv)

    from tpuslam.post.trajectory import ate_rmse, load_kitti_trajectory, rpe_stats

    est = load_kitti_trajectory(args.estimate)
    gt = load_kitti_trajectory(args.groundtruth)
    out = {
        "frames": int(min(len(est), len(gt))),
        "ate_rmse": ate_rmse(est, gt, align_scale=not args.no_scale),
        **rpe_stats(est, gt, delta=args.rpe_delta),
    }
    print(json.dumps(out))

    if args.plot:
        from tpuslam.post.visualizer import plot_trajectory

        plot_trajectory(est, args.plot, gt_poses=gt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
