"""Process set-up: compile-cache placement, the peak table, and the
on-card smoke script's refusal to run without a GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from tpuslam.utils import platform
from tpuslam.utils.profiling import PEAKS, peaks_for

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    platform.enable_compilation_cache()
    assert platform.compilation_cache_dir() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # left to JAX


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    platform.enable_compilation_cache()
    want = str(REPO / ".jax_cache")
    assert platform.compilation_cache_dir() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_peaks_unknown_device_kind_raises():
    assert peaks_for("NVIDIA H100 80GB HBM3")["hbm_bytes"] == 3.35e12
    assert "cpu" not in PEAKS
    with pytest.raises(ValueError, match="no peak rates"):
        peaks_for("cpu")


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert r.returncode != 0
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is False
    assert last["device"]["platform"] == "cpu"
