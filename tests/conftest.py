"""Test configuration: run JAX on CPU with 8 virtual devices.

Sharding tests exercise a simulated 8-device mesh on the host CPU. Must run
before jax is imported anywhere. Tests that need a GPU carry the `gpu`
marker and take the `gpu_device` fixture, which skips them without one; on
a machine with a card, run them with

    PLUTRACER_TEST_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu -n 0
"""

import os

PLATFORMS = os.environ.get("PLUTRACER_TEST_PLATFORMS", "cpu")
os.environ["JAX_PLATFORMS"] = PLATFORMS
# keep the persistent XLA compilation cache out of the test process: CPU
# test compiles are cheap, and concurrent writers can corrupt it
os.environ["PLUTRACER_NO_CACHE"] = "1"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", PLATFORMS)

import pathlib

import pytest

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
SCENES = REPO_ROOT / "scenes"


@pytest.fixture(scope="session")
def scenes_dir():
    return SCENES


@pytest.fixture(scope="session")
def eight_devices():
    import jax

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: run `gpu`-marked tests on a machine with
    a card and without JAX_PLATFORMS=cpu (see README, "Tests / bench")."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (this run has none)")
    return devs[0]
