"""Test harness configuration.

All tests run on a virtual 8-device CPU mesh so that multi-device sharding
(jax.sharding.Mesh + shard_map) is exercised without accelerator hardware.
Tests that need the GPU are marked ``gpu`` and take the ``gpu`` fixture,
which decides at run time whether a card is present and skips otherwise.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import subprocess
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_env() -> dict:
    """Environment for a child process that runs on jax's default platform
    (this process is pinned to the CPU)."""
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    env["PYTHONPATH"] = REPO_ROOT
    return env


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC71)


@pytest.fixture(scope="session")
def gpu():
    """The environment for a child process on the GPU; skips the test
    unless such a child finds a GPU as jax's default device."""
    env = card_env()
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    if probe.returncode != 0 or probe.stdout.strip() != "gpu":
        pytest.skip("no GPU: run on a machine with an NVIDIA card")
    return env
