"""Persistent XLA compilation cache for the entry points.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing is set here.  Otherwise the cache goes to ``.jax_cache/`` at
the root of the checkout: a fixed path, so that a later process of the
same checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os

#: the checkout's own cache directory (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
