"""Persistent XLA compilation cache.

A cold start compiles every frame program of the session; JAX's
persistent compilation cache keeps those executables across processes so
a later run of the same program skips the compile. The reference has no
analog — Vulkan pipelines ship a driver-managed pipeline cache implicitly.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses that directory and
nothing here overrides it; otherwise the cache lives at the fixed path
``<repo>/.jaxcache`` (gitignored — the path is part of the cache key, so
it must not move between runs).

Call :func:`enable_compilation_cache` BEFORE the first ``jax.jit``
execution; enabling after traced executables exist only helps later
compiles.
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jaxcache")


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory."""
    import jax

    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not d:
        d = DEFAULT_CACHE_DIR
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    # cache everything that took >1 s to compile, regardless of size
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return d
