"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (bench, scripts, ``chip_smoke.py``): if
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here; otherwise the cache goes to ``.jax_cache/`` at the checkout
root. The path is fixed because it is part of the cache key: a directory
that moves between runs never hits.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (module
    doc) and return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
