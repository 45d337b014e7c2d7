"""Test harness config: run all tests on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated without GPUs via
xla_force_host_platform_device_count (SURVEY.md §4 test plan). The platform
is set through jax.config as well as the environment, in case jax was
imported before this file. Tests marked `gpu` need the card and skip here
(see the `gpu` fixture).
"""
import os
import sys

import pytest

# The repo root, for the scripts at its top (chip_smoke.py).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The card's tests run with JAX_PLATFORMS=cuda,cpu (README); anything else
# runs on the CPU.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Persistent compile cache (uwslam_tpu keeps it in the checkout's .jax_cache/):
# recompiles dominate wall-time on small CI boxes.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run on the card: python -m pytest -m gpu)")
