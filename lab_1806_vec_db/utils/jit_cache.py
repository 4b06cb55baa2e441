"""Persistent XLA compilation cache.

Enabled at package import: index workloads re-run the same jitted kernels
across processes (DB reopen, bench sweeps, tests), and compiling the
beam-search while_loops takes tens of seconds.  The cache lives where
JAX_COMPILATION_CACHE_DIR says (JAX reads that variable itself); when it is
unset, in `.jax_cache` at the root of the checkout, a fixed path so that
later processes find it.
"""

from __future__ import annotations

import os

_enabled = False


def enable() -> None:
    global _enabled
    if _enabled:
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        jax.config.update("jax_compilation_cache_dir", os.path.join(root, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _enabled = True
