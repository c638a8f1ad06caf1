"""Test configuration.

Tests run on a virtual 8-device CPU mesh so sharding code paths are exercised
without GPUs (``chip_smoke.py`` and ``bench.py`` run on the GPU).  float64 is
enabled so CPU tests can act as high-precision oracles for the float32
device path.
"""

import os

# Force CPU even on a machine with a GPU: tests run on the virtual 8-device
# CPU mesh.  Installed pytest plugins (jaxtyping) may import jax before this
# conftest runs, so the env var alone is not enough — also flip the config
# knob, which works as long as no backend has been initialized yet.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu", "tests must run on CPU"
assert len(jax.devices()) == 8, "tests expect an 8-device virtual CPU mesh"
