"""Persistent-compilation-cache setup for entry points.

XLA compiles of the fusion graphs take seconds to minutes; caching them
makes repeat invocations start faster. The cache lives where
``JAX_COMPILATION_CACHE_DIR`` says; without it, in ``.jax_cache`` at the
root of the checkout (one fixed path, so entries are found again). Opt
out with CDMI_NO_COMPILE_CACHE=1.
"""

from __future__ import annotations

import os

__all__ = ["compile_cache_dir", "enable_compile_cache"]

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable_compile_cache(min_compile_secs: float = 1.0) -> None:
    if os.environ.get("CDMI_NO_COMPILE_CACHE"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
