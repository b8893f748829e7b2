"""Trajectory output + evaluation (the reference's postprocessing layer).

The reference ``Visualizer`` is an empty skeleton
(``include/slam/postprocessing/visualizer.hpp:10-17``, 0-byte CMake target);
its working visual output lives in tests (``test_pose_estimator.cpp:45-106``).
This module provides the production equivalents: KITTI-format trajectory
files and the standard ATE/RPE metrics used as the parity arbiter
(BASELINE.json north star: ATE RMSE within 5%).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def save_kitti_trajectory(poses: np.ndarray, path: str | Path) -> None:
    """Write (N, 4, 4) camera-to-world poses as KITTI 12-value rows."""
    poses = np.asarray(poses)
    rows = poses[:, :3, :].reshape(len(poses), 12)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(" ".join(f"{v:.9e}" for v in r) + "\n")


def load_kitti_trajectory(path: str | Path) -> np.ndarray:
    """Read KITTI 12-value rows → (N, 4, 4)."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    n = len(data)
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :] = data
    return out


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning src → dst (N, 3) points.

    Returns (R, t, s) with ``dst ≈ s · R @ src + t``.  Monocular VO has a
    free global scale, so ATE is computed after Sim(3) alignment.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s) if var_s > 0 else 1.0
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(
    est_poses: np.ndarray, gt_poses: np.ndarray, align_scale: bool = True
) -> float:
    """Absolute trajectory error (RMSE of translation) after Sim(3) alignment."""
    p_est = np.asarray(est_poses)[:, :3, 3]
    p_gt = np.asarray(gt_poses)[:, :3, 3]
    n = min(len(p_est), len(p_gt))
    p_est, p_gt = p_est[:n], p_gt[:n]
    R, t, s = umeyama_alignment(p_est, p_gt, with_scale=align_scale)
    aligned = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(aligned - p_gt, axis=1)
    return float(np.sqrt((err**2).mean()))


def rpe_stats(
    est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
) -> dict[str, float]:
    """Relative pose error over ``delta``-frame intervals (trans m, rot deg)."""
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)
    n = min(len(est), len(gt)) - delta
    terrs, rerrs = [], []
    for i in range(n):
        d_est = np.linalg.inv(est[i]) @ est[i + delta]
        d_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(d_gt) @ d_est
        terrs.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerrs.append(np.degrees(np.arccos(c)))
    return {
        "rpe_trans_rmse": float(np.sqrt(np.mean(np.square(terrs)))) if terrs else 0.0,
        "rpe_rot_rmse_deg": float(np.sqrt(np.mean(np.square(rerrs)))) if rerrs else 0.0,
    }
