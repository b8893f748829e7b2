"""Checkpoint resume: a split run must reproduce the uninterrupted run.

The reference has no persistence at all (SURVEY §5); this is the
framework's resume path: ``--save-state`` writes the tracking carry
(``VoState``) + trajectory, ``--resume`` restores them and continues the
stream at the saved frame.  Per-frame PRNG keys fold in the *global* frame
index (``model/slam.py`` step 5), so RANSAC sampling — and therefore the
trajectory — is bit-identical however the run is split.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parent.parent
CLI = REPO_ROOT / "tools" / "cli.py"


def _run_cli(*args: str) -> None:
    proc = subprocess.run(
        [sys.executable, str(CLI), *args],
        capture_output=True,
        text=True,
        timeout=900,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        cwd=REPO_ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_split_run_equals_single_run(tmp_path, data_dir):
    stream = str(data_dir / "images")
    cfg = str(REPO_ROOT / "configs")

    full = tmp_path / "full.txt"
    _run_cli("-c", cfg, "-v", stream, "-o", str(full), "--batch-size", "4")

    ckpt = tmp_path / "ckpt.npz"
    part1 = tmp_path / "part1.txt"
    _run_cli(
        "-c", cfg, "-v", stream, "-o", str(part1), "--batch-size", "4",
        "--max-frames", "6", "--save-state", str(ckpt),
    )
    part2 = tmp_path / "part2.txt"
    _run_cli(
        "-c", cfg, "-v", stream, "-o", str(part2), "--batch-size", "4",
        "--resume", str(ckpt),
    )

    T_full = np.loadtxt(full)
    T_split = np.loadtxt(part2)
    assert T_full.shape == T_split.shape == (10, 12)
    # Identical frame keys + identical carry ⇒ identical trajectories.
    np.testing.assert_allclose(T_split, T_full, rtol=0, atol=1e-6)
    # and the first segment is a strict prefix
    T_part1 = np.loadtxt(part1)
    np.testing.assert_allclose(T_part1, T_full[: len(T_part1)], rtol=0, atol=1e-6)


def _slam_split_run(tmp_path, data_dir, tracking):
    stream = str(data_dir / "images")
    cfg = str(REPO_ROOT / "configs")
    mode = ["--slam", "--tracking", tracking]

    full = tmp_path / f"full_{tracking}.txt"
    _run_cli("-c", cfg, "-v", stream, "-o", str(full), "--batch-size", "4", *mode)

    ckpt = tmp_path / f"ckpt_{tracking}.npz"
    part1 = tmp_path / f"part1_{tracking}.txt"
    _run_cli(
        "-c", cfg, "-v", stream, "-o", str(part1), "--batch-size", "4",
        "--max-frames", "6", "--save-state", str(ckpt), *mode,
    )
    part2 = tmp_path / f"part2_{tracking}.txt"
    _run_cli(
        "-c", cfg, "-v", stream, "-o", str(part2), "--batch-size", "4",
        "--resume", str(ckpt), *mode,
    )

    T_full = np.loadtxt(full)
    T_split = np.loadtxt(part2)
    assert T_full.shape == T_split.shape == (10, 12)
    # chunk-indexed keys + restored carries (tracking, map, keyframe DB,
    # BA schedule) + deferred end-of-run folding ⇒ identical trajectories
    np.testing.assert_allclose(T_split, T_full, rtol=0, atol=1e-6)


def test_slam_split_run_equals_single_run(tmp_path, data_dir):
    """--slam checkpoints the whole system state."""
    _slam_split_run(tmp_path, data_dir, "vo")


def test_slam_pnp_split_run_equals_single_run(tmp_path, data_dir):
    _slam_split_run(tmp_path, data_dir, "pnp")


def test_slam_resume_through_relocalization_event(tmp_path, data_dir):
    """A relocalization rescue (lost frames 4-5, BoW re-anchor at 6) must
    survive a checkpoint split placed right at the rescue: the keyframe DB
    (incl. stored absolute poses) and the corrected chain pose are all in
    the checkpoint, so split == single bit-for-bit."""
    import cv2

    src = data_dir / "images"
    corrupted = tmp_path / "images_corrupted"
    corrupted.mkdir()
    rng = np.random.default_rng(0)
    for i, p in enumerate(sorted(src.glob("*.png"))):
        img = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        if i in (4, 5):
            img = rng.integers(0, 256, img.shape, dtype=np.uint8)
        cv2.imwrite(str(corrupted / p.name), img)
    ts = src / "timestamps.txt"
    if ts.exists():
        (corrupted / "timestamps.txt").write_text(ts.read_text())

    cfg = str(REPO_ROOT / "configs")
    stream = str(corrupted)
    full = tmp_path / "full.txt"
    _run_cli("-c", cfg, "-v", stream, "-o", str(full), "--batch-size", "4",
             "--slam")
    ckpt = tmp_path / "ckpt.npz"
    part1 = tmp_path / "part1.txt"
    _run_cli("-c", cfg, "-v", stream, "-o", str(part1), "--batch-size", "4",
             "--max-frames", "8", "--save-state", str(ckpt), "--slam")
    part2 = tmp_path / "part2.txt"
    _run_cli("-c", cfg, "-v", stream, "-o", str(part2), "--batch-size", "4",
             "--resume", str(ckpt), "--slam")

    T_full = np.loadtxt(full)
    T_split = np.loadtxt(part2)
    assert T_full.shape == T_split.shape == (10, 12)
    np.testing.assert_allclose(T_split, T_full, rtol=0, atol=1e-6)
    # the rescue actually happened: frame 6 is not a copy of frame 3's pose
    # (the carried stale pose) but jumps forward in z
    z = T_full[:, 11]
    assert z[6] - z[3] > 1.5, z
