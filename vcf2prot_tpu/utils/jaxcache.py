"""Persistent XLA compilation cache.

Big fused programs (the dense neoantigen pass, multi-operand sorts) take
seconds to compile, and nothing amortizes those compiles across processes
unless the persistent compilation cache is on. So every device entry point
(the device engine, DeviceNeoantigenEngine, the batched scorer, the sharded
executor, the validator) calls :func:`enable_persistent_cache` before
building its first jit.

Cache directory: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and this module sets no other directory; otherwise the fixed
``<repo>/.jax_cache`` (gitignored). The path is part of the cache key, so a
directory that moves never hits.
"""
from __future__ import annotations

import os

_DONE = False

ENV_DIR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<repo>/.jax_cache``: the directory used when ``ENV_DIR`` is unset."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, ".jax_cache")


def enable_persistent_cache() -> None:
    """Idempotently turn on JAX's persistent compilation cache."""
    global _DONE
    if _DONE:
        return
    _DONE = True
    import jax

    # CPU-backend runs (the test suite, virtual meshes) skip the cache:
    # XLA:CPU AOT cache entries are pinned to the machine's CPU features and
    # reloading them across toolchain drift warns or worse
    if jax.default_backend() == "cpu":
        return
    if not os.environ.get(ENV_DIR):
        path = default_cache_dir()
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache everything: the small compiles are cheap to keep
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
