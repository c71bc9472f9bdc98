"""JAX's persistent compilation cache for this package's entry points."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``:
    a path fixed by where this package is, so later runs from the same
    checkout find what earlier runs compiled."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache in :func:`cache_dir` and
    return it.  A directory given by the environment is left to JAX,
    which reads the variable itself."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
