"""Persistent XLA compilation cache setup.

Compiling the extraction, head and sweep programs takes seconds per shape;
jax's persistent cache amortises that across processes (bench runs, chip
checks, tests, user sessions). Where ``JAX_COMPILATION_CACHE_DIR`` is set,
jax already reads it and no other directory is set here; otherwise the
cache lives at the fixed ``<checkout>/.jax_cache`` (the path is part of the
cache key, so it must not move between runs).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; return the directory it uses."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
