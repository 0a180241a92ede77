"""Where JAX keeps its persistent compilation cache.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set the program
sets nothing.  Otherwise the entry points point the cache at one fixed
directory inside the checkout, ``<repo>/.jax_cache``: the cache key holds
the path, so a name that changed per run (a temporary directory, a process
id, the time) would never hit.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup_compile_cache() -> str:
    """Place JAX's compile cache; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
