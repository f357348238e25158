"""Persistent XLA compilation cache for entry points (chip_smoke.py, bench.py,
tools/*).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there and this
module names no other directory. Otherwise the cache lives at a fixed path in
the checkout, ``<checkout>/.jax_cache`` (git-ignored): the path is part of
the cache key, so a directory that moved would never hit.

Library code must NOT enable this implicitly — only entry points opt in.
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache every program, even quick compiles: a cold 13B run compiles many
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
