"""Where the entry-point scripts keep JAX's persistent compilation cache.

The library modules set no cache; ``chip_smoke.py``, ``bench.py``,
``examples/*.py`` and ``scripts/*.py`` call :func:`enable_compile_cache`
before their first compile.  The cache is keyed by its path, so the
default is one fixed directory in the checkout (listed in
``.gitignore``), never a temporary or per-process name.
"""

from __future__ import annotations

import os

__all__ = ["compile_cache_dir", "enable_compile_cache"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir`; returns it.

    When the environment variable is set JAX already reads it, and this
    sets the same directory, no other."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
