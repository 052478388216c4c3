"""Persistent XLA compilation cache.

The jitted steps and evaluators compile at run time. JAX's persistent
compilation cache serializes compiled executables to disk keyed by (HLO,
compile options, backend), so a process re-running an already-seen shape
loads instead of recompiling: the serving story's first refresh at a
(bucketed) catalog shape, and the propagation-cache cold start.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps the cache there and
this module sets no other directory. Otherwise the cache goes to a fixed
path inside the checkout, ``.cache/xla`` (listed in ``.gitignore``): the
path is part of what a later process has to find. The engine A/B memo
(kernels/pcache.py) lives beside it, in ``.cache/``.

Call ``enable_persistent_cache()`` once, before the first jit dispatch.
Every entry point does (cli/main.py, bench.py, serve.Recommender,
chip_smoke.py). Opt out with IGCN_COMPILE_CACHE=off.
"""

from __future__ import annotations

import os

_ENABLED = False

ENV_DIR = "JAX_COMPILATION_CACHE_DIR"

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def state_dir() -> str:
    """The checkout's own state directory (``.cache/``, gitignored)."""
    return os.path.join(_CHECKOUT, ".cache")


def compile_cache_dir() -> str:
    """Where the compilation cache lives: ``JAX_COMPILATION_CACHE_DIR`` if
    set, else ``.cache/xla`` inside the checkout."""
    return os.environ.get(ENV_DIR) or os.path.join(state_dir(), "xla")


def enable_persistent_cache() -> str | None:
    """Idempotent. Returns the cache dir, or None if disabled."""
    global _ENABLED
    if os.environ.get("IGCN_COMPILE_CACHE", "").lower() in (
        "off", "0", "disable", "disabled"
    ):
        return None
    cache_dir = compile_cache_dir()
    if _ENABLED:
        return cache_dir
    import jax

    if not os.environ.get(ENV_DIR):
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache everything that takes real compile time; the default 1 GiB
    # min-entry gate would skip every program in this workload
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    _ENABLED = True
    return cache_dir
