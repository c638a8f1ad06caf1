"""Process-level JAX setup shared by the entry points and scripts."""

from __future__ import annotations

import os

CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPILE_CACHE_DIR = os.path.join(CHECKOUT_DIR, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache lives in the fixed,
    git-ignored ``<checkout>/.jax_cache``: a fixed path, because a cache
    directory that moves between runs never hits.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR
