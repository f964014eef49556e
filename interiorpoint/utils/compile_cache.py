"""Where JAX keeps its persistent compilation cache for this program.

The cache's directory is part of its key, so it must not move between
runs: either the one ``JAX_COMPILATION_CACHE_DIR`` names, or a fixed
directory inside the checkout (listed in ``.gitignore``)."""

from __future__ import annotations

import os

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    no other directory is set in code; otherwise the cache goes to
    ``CHECKOUT_CACHE_DIR``."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    os.makedirs(CHECKOUT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
