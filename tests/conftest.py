"""Test configuration: run everything on an 8-device virtual CPU mesh.

Must set flags before jax initializes a backend — hence module level, and
conftest is imported before any test module.
"""

import os

# force, not setdefault: the tests run on the host CPU even where an
# accelerator is present (tests that need the card are marked `gpu`)
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# persistent compilation cache inside the checkout: repeated test runs
# skip recompiles
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".cache", "jax_tests"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
