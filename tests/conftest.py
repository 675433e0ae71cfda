"""Test configuration.

Tests run on the CPU backend with 8 virtual devices, so multi-device
sharding paths (`qcss_tpu.parallel`) are exercised without accelerators,
and pytest-xdist workers never open a GPU (each JAX process that touches
a card reserves most of its memory). Every run is held to the CPU,
whatever ``JAX_PLATFORMS`` says, except a single-process run that selects
the GPU-marked tests; that one keeps the environment's platforms:

    python -m pytest tests/ -m gpu -p no:xdist

`chip_smoke.py` runs the same checks on the card.

Must run before jax initializes a backend: the device count is set at
import time, the platform in ``pytest_configure`` (before collection).
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


def _gpu_run(config) -> bool:
    """A single-process run of ``-m gpu``: the only run that may open a
    card. xdist workers and the controller of ``-n N`` never do."""
    return (config.getoption("markexpr", "") == "gpu"
            and "PYTEST_XDIST_WORKER" not in os.environ
            and not config.getoption("numprocesses", None))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on the CPU backend "
        "(chip_smoke.py runs the same checks on the card)")
    if not _gpu_run(config):
        os.environ["JAX_PLATFORMS"] = "cpu"  # also for subprocesses
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when the process has none.
    Decided here, at run time, never while test modules are imported."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU in this process (tests run on the CPU backend)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    The suite performs ~700 XLA CPU compilations in one process; past a
    threshold the CPU backend's compiler segfaults inside
    backend_compile_and_load on an otherwise-fine program (reproduced on
    jax 0.9: the full suite crashed in whichever module compiled next,
    while any ~90% subset passed). Dropping the live-executable caches
    between modules keeps the process under that edge; per-module
    recompiles of shared helpers cost far less than the lost run.
    """
    yield
    jax.clear_caches()
