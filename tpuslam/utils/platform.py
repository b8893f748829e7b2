"""Process start-up: JAX platform selection and the persistent compile cache.

Call :func:`apply_env_platform` at tool/script startup.  It honours a
``JAX_PLATFORMS`` set in the environment through ``jax.config`` as well
(harmless when already correct) and enables the compile cache.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def apply_env_platform() -> None:
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms:
        import jax

        jax.config.update("jax_platforms", platforms)
    enable_compilation_cache()


def compilation_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT_CACHE_DIR)


def enable_compilation_cache() -> None:
    """Persist XLA compilations across processes.

    The full-SLAM sequence programs take minutes to compile; the on-disk
    cache lets every later process start in seconds.  A cache directory
    given by ``JAX_COMPILATION_CACHE_DIR`` is left to JAX, which reads the
    variable itself; otherwise the cache lives in the checkout, at a fixed
    path so that later processes find it.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
