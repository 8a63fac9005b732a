"""Persistent XLA compilation cache.

The PM solve, the kernels and the rasterizer cost seconds to minutes of
compile time on first use. JAX's persistent compilation cache makes that a
once-per-checkout cost: later processes load the compiled executable from
disk. Every entry point (cli, server, bench, chip_smoke) calls ``enable``.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
there and nothing here changes that. Otherwise the cache lives at a fixed
path inside the checkout (``<repo>/.jax_cache``, listed in .gitignore): a
fixed path, because the path is part of every cache key and a directory
that moves never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Enable the persistent compile cache; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path
