"""Persistent XLA compilation cache.

Compiles of the full model take seconds to minutes; the persistent cache
makes them one-time per program shape across processes. Call once at
entry-point startup (CLI, bench, chip smoke, graft entry) — never from
library import side effects.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and no
directory is set here. Otherwise the cache lives at the fixed
`<repo root>/.jax_cache`: the path is part of what makes a later process
find the entries, so it never depends on a temp name, pid or time.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import jax

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> Optional[str]:
    """The directory this module sets, or None when JAX_COMPILATION_CACHE_DIR
    is left to JAX."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(DEFAULT_DIR)


def enable_persistent_compilation_cache() -> None:
    path = cache_dir()
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
