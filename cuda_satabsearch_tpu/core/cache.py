"""Persistent XLA compilation cache.

The search programs compile once per (query order, bucket shape); the
cache lets every later process reuse them (the analog of the
reference's ahead-of-time nvcc build, cudaSaTabsearch Makefile:92-116).

The cache's path is part of its key, so it is fixed: the directory
``JAX_COMPILATION_CACHE_DIR`` names when that variable is set (JAX reads
it itself, and nothing else is changed), otherwise ``.jax_cache`` at the
root of the checkout (listed in .gitignore).
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory;
    returns that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    if jax.config.jax_compilation_cache_dir != CACHE_DIR:
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
