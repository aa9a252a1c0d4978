"""Persistent XLA compile cache location.

One rule for every entry point (CLI, bench, chip smoke test, scripts): when
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing here
overrides it; otherwise the cache lives at a fixed directory inside the
checkout (listed in .gitignore).  A fixed path matters: the directory is
part of the cache key, so a cache that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
