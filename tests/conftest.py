"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated on fake CPU devices
(`--xla_force_host_platform_device_count=8`). Nothing here needs a GPU;
the on-card checks are `chip_smoke.py` (and `chip_smoke.py --four-cards`),
run on a machine with the GPU(s), and timings come from `bench.py` there.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# Persistent compile cache: XLA CPU compiles are slow and the test suite
# re-traces the same kernels every run.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_cache")

import jax  # noqa: E402

# tests run on the local CPU even where JAX would pick an accelerator
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
