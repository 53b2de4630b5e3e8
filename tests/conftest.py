"""Test configuration: force the CPU with 8 virtual devices so sharding
tests run without several cards (SURVEY §4: the standard way to test
shard_map collectives). Pallas kernels run in interpret mode here.

Checks that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them on the CPU; on the card the same
check functions run as phases of ``python chip_smoke.py``."""

import os

# tests run on the local CPU whatever platform the environment names
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import pytest  # noqa: E402

ASSETS = "/root/reference/assets"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on the CPU; "
        "chip_smoke.py runs these checks on the card)")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never while
    modules are collected."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU: run python chip_smoke.py there")
    return gpus[0]


@pytest.fixture(scope="session")
def assets_dir():
    return ASSETS
