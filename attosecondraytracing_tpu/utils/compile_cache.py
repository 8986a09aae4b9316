"""Persistent XLA compilation cache at a fixed path.

Entry points (the CLI, ``bench.py``, ``chip_smoke.py``) call
:func:`enable_compile_cache` before their first compile; importing the
package sets nothing. ``JAX_COMPILATION_CACHE_DIR``, when set, wins and JAX
reads it itself. Otherwise the cache lives in ``.jax_cache/`` at the root of
the checkout: the directory is part of the cache key, so it must not move
between runs (no temporary names, process ids or timestamps).
"""

from __future__ import annotations

import os
from pathlib import Path

#: the checkout's own cache directory (listed in .gitignore)
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
