"""Test configuration: force CPU with 8 virtual devices and fp64 enabled.

Multi-device sharding is validated on a virtual CPU mesh (the analogue of
"multi-node without a cluster", which the reference lacks — SURVEY.md §4).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "cpu_enable_fast_math" not in flags:
    # XLA:CPU fast-math would break the compensated double-float arithmetic
    # (TPU compilation never reassociates these)
    flags = (flags + " --xla_cpu_enable_fast_math=false").strip()
os.environ["XLA_FLAGS"] = flags

import jax

# NOTE: jax may be pre-imported by the host harness, so environment
# variables are ineffective — use config updates (pre-backend-init).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
try:
    # jit executables only: cached XLA:CPU AOT kernels pin exact host
    # features and warn/SIGILL when reloaded under a different feature
    # detection (the cpu_aot_loader noise in test logs)
    jax.config.update("jax_persistent_cache_enable_xla_caches", "none")
except Exception:
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA "
        "kernels); skipped without one")
