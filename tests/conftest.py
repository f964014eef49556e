"""Test configuration: run the suite on a virtual 8-device CPU mesh with
float64 enabled, per SURVEY.md §4 (multi-host tests simulated with
``xla_force_host_platform_device_count``).

``python -m pytest -m gpu tests/`` runs the tests marked ``gpu`` on the
default backend instead (an NVIDIA GPU); everywhere else they skip."""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is an NVIDIA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu)")
    return jax.devices()[0]
