"""JAX's persistent compilation cache, kept at one fixed place.

The cache's key includes its directory, so a directory that moves between
runs never hits. Entry points (the CLI, the benchmark, the smoke check,
the tools) call `enable()` before their first compile; importing the
package sets nothing, so test workers never write a cache.
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<checkout>/.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO_ROOT, ".jax_cache"
    )


def enable() -> str:
    """Point JAX's persistent cache at `cache_dir()` and return it.

    When `JAX_COMPILATION_CACHE_DIR` is set JAX reads it itself, and
    nothing is set here.
    """
    d = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", d)
    return d
