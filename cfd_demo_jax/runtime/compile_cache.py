"""Persistent XLA compilation cache for the entry points.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
this module sets nothing. Otherwise the cache goes to ``.jax_cache/``
at the root of the checkout: a fixed path, never a temporary or
per-process one, because a cache that moves is never hit again.

Called from ``main()``s and scripts, not at package import, so that
importing the library changes no global JAX configuration.
"""
from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
