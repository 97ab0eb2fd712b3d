"""Persistent XLA compilation cache, one policy for every entry point.

The apps, `bench.py`, `chip_smoke.py` and `__graft_entry__.py` call
`enable()` before their first compile. The cache lives where
`JAX_COMPILATION_CACHE_DIR` says when that is set, and otherwise at
`<checkout>/.jax_cache`. The path is part of the cache key, so it is fixed:
never a temp, per-process or time-stamped directory.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# the checkout root: two levels above this package's utils/ directory
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent compile cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()` and return
    the path. Setting the config (not only the environment variable) is what
    makes it take effect after `import jax`."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
