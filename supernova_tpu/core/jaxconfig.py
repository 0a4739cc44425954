"""JAX runtime configuration for the framework's entry points.

One decision is made here and read everywhere else: does the process run
on an accelerator (the GPU) or on the CPU backend?  Device-only choices
(mesh on by default, device closure glue, ragged collectives, the
persistent compile cache) follow from `on_accelerator()`.  Called by the
pipeline, CLI, bench, smoke and `__graft_entry__.py`.
"""
from __future__ import annotations

import os
from pathlib import Path

_DONE = False
_PLATFORM_DONE = False

# Default persistent-cache location when JAX_COMPILATION_CACHE_DIR is unset:
# one fixed path inside the checkout (listed in .gitignore), so every run of
# this tree finds what an earlier run compiled.
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def ensure_platform(platform: str | None = None):
    """Force the JAX backend (e.g. "cpu") before any computation runs.

    `jax.config.update` takes effect even where the JAX_PLATFORMS env var
    was read before this process could change it.  No-op when neither
    `platform` nor SUPERNOVA_TPU_PLATFORM is set.
    """
    global _PLATFORM_DONE
    plat = platform or os.environ.get("SUPERNOVA_TPU_PLATFORM")
    if not plat or _PLATFORM_DONE:
        return
    _PLATFORM_DONE = True
    import jax

    jax.config.update("jax_platforms", plat)


def on_accelerator() -> bool:
    """True when JAX's default backend is an accelerator (not the CPU)."""
    import jax

    return jax.default_backend() != "cpu"


def cache_dir(accelerator: bool | None = None) -> str | None:
    """Where the persistent compile cache lives for this process, or None.

    JAX_COMPILATION_CACHE_DIR, when set, is the only cache: JAX reads it
    itself and nothing is set in code.  Otherwise an accelerator process
    caches at REPO_CACHE_DIR.  The CPU backend gets no cache from this
    module: (de)serializing executables compiled for the multi-device CPU
    backend (tests and the graft-entry dryrun use 8 virtual devices) segfaults
    flakily inside compilation_cache.{get,put}_executable_and_time with
    this jaxlib, and CPU compiles are fast anyway."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if accelerator is None:
        accelerator = on_accelerator()
    return str(REPO_CACHE_DIR) if accelerator else None


def ensure_cache():
    global _DONE
    if _DONE:
        return
    _DONE = True
    import jax

    if not on_accelerator():
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir(True))
    # cache every program: the pipeline compiles dozens of shapes per run
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
