"""Persistent XLA compilation cache.

Compiles of the hybrid kernel take seconds per distinct shape signature
and dominate the autotune shootout's device time (~10 finalists per
matrix).  The persistent cache makes any re-compilation of an identical
program (bench re-runs on committed configs, probe re-runs, suite
--resume) near-free across processes.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing; otherwise the cache lives at the fixed
``<repo>/.jax_cache`` (a fixed path: the path is part of the cache key).

Reference counterpart: CUDA kernels are AOT-compiled by nvcc; this
restores the same run-many-times economics for the JIT path.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def _configured_platform() -> str:
    """First configured JAX platform, read without initializing a
    backend ("" when JAX chooses)."""
    import jax
    platforms = (jax.config.jax_platforms
                 or os.environ.get("JAX_PLATFORMS", ""))
    return platforms.split(",")[0]


def enable_persistent_cache() -> str:
    """Idempotently turn on JAX's persistent compilation cache and
    return the directory in use (``""`` on the CPU backend, whose AOT
    entries embed host machine features and are cheap to rebuild)."""
    if _configured_platform() == "cpu":
        return ""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    if jax.config.jax_compilation_cache_dir != DEFAULT_DIR:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
        # cache every compilation that took >= 0.5 s (default 1 s)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          0.5)
    return DEFAULT_DIR
