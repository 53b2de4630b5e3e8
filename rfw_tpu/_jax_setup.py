"""Process-wide JAX configuration applied on first rfw_tpu compute import.

Persistent compilation cache: where ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX reads it itself and this module sets nothing. Otherwise the cache lives
at the fixed path ``<checkout>/.jax_cache`` (git-ignored), so every process
run from one checkout shares it: the path is part of the cache key.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

_done = False


def cache_dir() -> str:
    """The compilation cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def setup() -> None:
    global _done
    if _done:
        return
    _done = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    try:
        os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except OSError:   # read-only checkout: run without a persistent cache
        pass


setup()
