"""Persistent XLA compile cache, shared by every entry point.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing is
set here. Otherwise the cache lives at a fixed `<checkout>/.jax_cache` (listed
in `.gitignore`), so that a later run in the same checkout finds what an
earlier one compiled; a temporary or per-process path would start empty.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[1] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; return it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
