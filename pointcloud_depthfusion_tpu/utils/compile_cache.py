"""Persistent XLA compilation cache setup.

The fusion and registration programs take seconds each to compile. JAX's
persistent compilation cache makes that a once-per-cache cost: later
processes (nodes, benches, tests on the same backend) load the compiled
programs from disk.

Call :func:`enable_persistent_cache` before the first jit compilation.
"""

from __future__ import annotations

import os

# Fixed, so that the cache key (which includes the path) stays the same
# from one run to the next. Listed in .gitignore.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache() -> str:
    """Enable the JAX persistent compilation cache. Returns the cache dir.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX itself reads it and
    this sets no directory. Otherwise the cache goes to ``.jax_cache`` at
    the root of the checkout. Safe to call more than once.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache every compilation that takes over a second — the hot-path
    # programs are all well past this; tiny test jits stay out.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
