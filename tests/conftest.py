"""Test configuration: force CPU with 8 virtual devices and 64-bit floats.

Tests run on a virtual 8-device CPU mesh so multi-chip sharding is validated
without TPU hardware.  NOTE: the environment preloads jax at interpreter
startup, so env vars alone are too late — the runtime config override
(``jax_platforms``) is what actually takes effect; XLA_FLAGS still works
because the CPU backend has not been initialized yet when conftest runs.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# the suite is compile-dominated (windowed kernels, 2-15 s each on CPU);
# the repo-local persistent cache amortizes them across runs
from starneig_tpu.node import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

assert jax.devices()[0].platform == "cpu", "tests must run on CPU"
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc; skips without one")
