"""Test harness configuration.

Tests run on a *virtual 8-device CPU mesh* so multi-device sharding logic is
exercised without GPUs.  These env vars must be set before JAX is imported.
Tests that need a GPU carry the ``gpu`` marker and the ``gpu`` fixture;
run them on a GPU machine with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import os
import sys
from pathlib import Path

# The CPU unless the caller names platforms (the ``gpu``-marked tests run
# on a GPU machine with JAX_PLATFORMS=cuda,cpu).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# jax may already be imported (e.g. by a plugin) before this conftest runs;
# it reads JAX_PLATFORMS at import, so update the live config too.
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU, for tests marked ``gpu``; skips where there is none.

    Decided when the test runs, never at import, so every xdist worker
    collects the same tests.
    """
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's device is {devices[0].platform}")
    return devices[0]


@pytest.fixture(scope="session")
def data_dir() -> Path:
    return REPO_ROOT / "tests" / "data"


@pytest.fixture(scope="session")
def kitti_frames(data_dir):
    """The 10 KITTI grayscale frames used as fixtures (uint8 arrays)."""
    from tpuslam.pre.png import read_png_gray

    frames = [read_png_gray(p) for p in sorted((data_dir / "images").glob("*.png"))]
    assert len(frames) == 10
    return frames


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Reset jax's in-process compilation caches after each test module.

    The XLA CPU compiler segfaulted (reproducibly, same test) compiling
    the PnP-relocalization sequence program ~140 compilations into a full
    suite run, while the same test compiles and passes standalone — a
    state-dependent compiler crash, not a code or memory issue (125 GB
    free at the time).  Clearing per-module keeps any single process's
    compiler state bounded; within-module caching (where reuse actually
    happens) is unaffected.
    """
    yield
    import jax

    jax.clear_caches()
