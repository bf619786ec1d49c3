"""Persistent XLA compilation cache setup.

The device tile kernels (ops/accumulate.py) compile once per bucket shape.
Because every bucket is a fixed power-of-two, the executables are perfectly
cacheable across runs — JAX's persistent compilation cache makes every run
after the first start hot. (The reference has the same pattern with its
binomial tables: built once, cached next to the binary,
src/GROM.c:21331-21355.)
"""

from __future__ import annotations

import os

# one fixed path inside the checkout: the cache directory is part of the
# cache key, so a path that moves between runs never hits
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

_done = False


def enable_persistent_cache() -> None:
    """Idempotently point JAX at a persistent on-disk compilation cache.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets nothing. Otherwise the cache goes to ``<repo>/.jax_cache/``."""
    global _done
    if _done:
        return
    _done = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    os.makedirs(REPO_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    # cache only non-trivial compiles so the directory does not grow
    # without bound from many workers persisting trivial entries
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
