"""Test configuration.

Tests run on the CPU, on a virtual 8-device mesh so multi-device sharding
logic is exercised without accelerators (SURVEY.md §4). The env vars must be
set before jax initializes its backends, hence this module-level setup. The
GPU is reached by `python chip_smoke.py` on a machine with a card.
"""

import os

# Force CPU even where a GPU is present: tests must not depend on (or
# monopolize) the card. The config update below, made before any backend
# initializes, pins it even if jax was imported first.
os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU, or a skip: tests marked `gpu` take this fixture, so
    the decision is made when the test runs, never at import."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU (tests run on the CPU here)")
    return devices[0]
