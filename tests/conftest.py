"""Test configuration: run on CPU with 8 virtual devices for mesh tests."""

import os

# the suite runs on the CPU, whatever accelerator the machine has
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import gc  # noqa: E402

import pytest  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_programs_between_modules():
    """Full-suite stability: the suite jits ~110+ distinct programs
    (including 8-virtual-device mesh executables); with all of them held
    live, the XLA CPU client segfaults deterministically inside
    backend_compile_and_load at ~test 123 (reproduced three times on
    this box, see NOTES round 5).  Dropping the executable caches at
    module boundaries keeps the compile arena bounded; modules recompile
    what they reuse (tests are compile-dominated either way)."""
    yield
    jax.clear_caches()
    gc.collect()
