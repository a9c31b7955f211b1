"""Test configuration: force an 8-device virtual CPU mesh.

Must run before jax initializes its backends, so this sits in conftest.py and
sets the env vars at import time.  The tests are hermetic CPU tests: a
machine with a GPU would otherwise run them there, with other numerics and
one device instead of eight.  Multi-device sharding tests run on the virtual
CPU mesh; the GPU is exercised by ``chip_smoke.py``, not by the tests.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# The config update is stronger than the env var: it also wins over a
# platform chosen by a site-wide configuration that imported jax earlier.
jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

REFERENCE_DIR = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_dir() -> pathlib.Path:
    if not REFERENCE_DIR.exists():
        pytest.skip("reference tree not mounted")
    return REFERENCE_DIR
