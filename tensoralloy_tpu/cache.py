"""Persistent XLA compilation cache for production serving.

A one-shot serving process (the reference's pattern: one `calculate()`
per LAMMPS/ASE driver process) pays the XLA compile of every executable
it touches, and at large cells the compile, not the compute, dominates
such a process. JAX's persistent compilation cache serializes compiled
executables to disk keyed by (HLO, compile options, backend), so every
process after the first starts warm.

Enabled automatically (idempotent) by `TensorAlloyCalculator` and the
CLI on accelerator backends. Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and nothing
  here touches the cache configuration.
* otherwise: one fixed directory inside the checkout,
  ``<checkout>/.jax_cache``, the same for every process, so a later
  process finds what an earlier one wrote.

Opt out with TENSORALLOY_NO_CACHE=1. CPU is excluded by default:
test/dev runs would write thousands of tiny executables for no
wall-clock win (CPU compiles are fast), and the suite pins numerics
with fresh compiles on purpose.
"""
from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")

_enabled = False


def enable_compilation_cache(include_cpu: bool = False) -> bool:
    """Idempotently turn on JAX's persistent compilation cache.

    Returns True when the cache is active after the call. Safe to call
    before or after the backend initializes; a failure (read-only
    filesystem, unsupported backend) degrades to no caching rather
    than raising.
    """
    global _enabled
    if _enabled:
        return True
    if os.environ.get("TENSORALLOY_NO_CACHE"):
        return False
    try:
        import jax

        if not include_cpu:
            # decide from the CONFIGURED platform, without initializing
            # a backend as a side effect of a cache hook
            configured = (getattr(jax.config, "jax_platforms", None)
                          or os.environ.get("JAX_PLATFORMS", ""))
            first = str(configured).split(",")[0].strip().lower()
            if first == "cpu":
                return False
        if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            _enabled = True
            return True
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
        _enabled = True
        return True
    except Exception:
        return False
