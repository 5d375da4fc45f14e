"""Test config: JAX on the CPU with 8 virtual devices, so multi-device
sharding paths are exercised without accelerators (SURVEY.md §4d).

`JAX_PLATFORMS` set from outside wins: the `gpu`-marked tests run on the
card with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
Test workers never write the persistent compilation cache that entry
points such as `run.main` turn on.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
