"""Where the persistent XLA compilation cache lives.

`JAX_COMPILATION_CACHE_DIR`, when set, names the directory and nothing
else is used.  Otherwise the cache sits at the fixed path
`<checkout>/.jax_cache` (listed in `.gitignore`): the path is part of the
cache key, so a location that moved between runs would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping, Optional

CHECKOUT = Path(__file__).resolve().parents[2]


def compile_cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    env = os.environ if environ is None else environ
    return env.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at `compile_cache_dir()`; returns it."""
    import jax

    d = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return d
