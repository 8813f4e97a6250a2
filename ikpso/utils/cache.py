"""Where the persistent XLA compile cache lives.

Every entry point (``bench.py``, ``chip_smoke.py``, the CLI, the tests)
calls :func:`enable_compile_cache` instead of choosing a directory of
its own. When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it at
start-up and this leaves that setting alone; otherwise the cache goes
to ``<checkout>/.jax_cache``, a fixed path derived from the package's
location (the path is part of the cache key, so a moving directory
would never hit).
"""

from __future__ import annotations

import os

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache`` (the directory holding the package)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Turn the persistent compile cache on; return its directory."""
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_secs
    )
    from_env = os.environ.get(CACHE_ENV)
    if from_env:
        return from_env
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
