"""Test configuration: force an 8-device CPU platform so multi-device
sharding logic runs without accelerators (the standard JAX testing
pattern)."""

import os

# Force override: the environment may pin JAX_PLATFORMS to an accelerator,
# but tests must run on the virtual 8-device CPU platform.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# jax reads JAX_PLATFORMS at import time, and something may have imported
# jax before this conftest runs — so the env var alone is not enough;
# update the live config too.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from cudadepthmapintegration_tpu.cli._cache import enable_compile_cache  # noqa: E402

# XLA compiles dominate test wall time; cache them across pytest processes.
enable_compile_cache(min_compile_secs=0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
