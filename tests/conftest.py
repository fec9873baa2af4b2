"""Test configuration: force an 8-device virtual CPU platform so tests
(including sharding tests) run anywhere, GPU or not.

The platform is pinned through jax.config as well as the environment, before
any backend is initialized (i.e. before test modules import).  Tests that
need the card are marked ``gpu``, take the ``gpu_name`` fixture, and drive
the card from a child process (this process stays on the CPU); elsewhere
they skip.  On a GPU machine: ``python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_name():
    """The card's ``nvidia-smi`` name and power limit, or a skip.  Decided
    when a test runs, never at import (xdist workers that collected
    different tests would run none)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        out = None
    if out is None or out.returncode != 0 or not out.stdout.strip():
        pytest.skip("needs an NVIDIA GPU")
    return out.stdout.strip().splitlines()[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    The full suite accumulates hundreds of compiled CPU programs; on this
    jax build the XLA:CPU client segfaults inside backend_compile_and_load
    once enough executables are live (reproduced at ~60% of the suite;
    either half alone passes).  Releasing the jit caches between modules
    keeps the live-executable count bounded at the cost of recompiling
    the few helpers shared across modules.
    """
    yield
    jax.clear_caches()
