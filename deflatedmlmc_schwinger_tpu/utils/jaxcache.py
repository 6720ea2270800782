"""Persistent XLA compilation cache.

Setup compiles ~15 distinct programs (per-level eigensolver filters, Galerkin
batches, the preconditioned FGMRES); the on-disk cache lets a later process
reuse those executables instead of compiling them again.

Where it lives: JAX itself reads ``JAX_COMPILATION_CACHE_DIR``, so when that
variable is set no directory is set here. Otherwise the cache sits at the
fixed ``<repo>/.jax_cache`` (the path is part of what makes a later run hit).
"""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str | None:
    """The directory to set in code: None when JAX_COMPILATION_CACHE_DIR
    already names one, else the repo's fixed ``.jax_cache``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE


def enable() -> None:
    """Enable JAX's persistent compilation cache (idempotent).

    Accelerator backends only: XLA:CPU persists ahead-of-time executables
    specialized to the compiling host's CPU features, and loading them has
    proved unreliable (sporadic segfaults inside the cache loader). CPU
    compiles take seconds, so the in-memory jit cache is enough there."""
    import jax

    if jax.default_backend() == "cpu":
        return
    path = cache_dir()
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
