"""Test config: force an 8-device virtual CPU mesh BEFORE jax initializes.

Mirrors the reference's testing stance (SURVEY.md §4): multi-host logic is
exercised on one host the way task_mgr_local runs the distributed framework
in-process — same sharded code path, virtual devices.
"""

import os

# The suite runs on the CPU backend; tests that need a GPU run on the card
# through chip_smoke.py instead.
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest

REFERENCE = "/root/reference"


@pytest.fixture(scope="session")
def golden_dir():
    return os.path.join(REFERENCE, "golden")


@pytest.fixture(scope="session")
def datasets_dir():
    return os.path.join(REFERENCE, "datasets")


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
