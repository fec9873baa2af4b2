"""Where this process keeps JAX's persistent compilation cache.

One rule for every entry point: when ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX reads it itself and nothing is set here; otherwise the cache lives at
``<checkout>/.jax_cache``, derived from this file's location, so the path
(part of the cache key) is the same for every run from one checkout.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_cache_dir() -> str:
    return os.path.join(_CHECKOUT, ".jax_cache")


def configure_compile_cache() -> str:
    """Set up the cache for this process and return its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
