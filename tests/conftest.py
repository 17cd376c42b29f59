"""Test configuration: an 8-device virtual CPU mesh and float64.

Tests validate numerics against the reference's float64 golden values and
sharding against a virtual mesh (SURVEY.md §4). The GPU path is exercised
by chip_smoke.py and by the tests marked ``gpu``, which run only in a
process started on the card with MPC_CBF_TEST_GPU=1 (README, "Running").
"""
import os

ON_GPU = os.environ.get("MPC_CBF_TEST_GPU") == "1"
# a GPU test process keeps the CPU backend too: the gpu tests compare
# the card's results with the CPU's
os.environ["JAX_PLATFORMS"] = "cuda,cpu" if ON_GPU else "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import pytest  # noqa: E402

from mpc_cbf_tpu.utils.runtime import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
enable_compile_cache()

if not ON_GPU:
    assert jax.devices()[0].platform == "cpu", (
        f"tests must run on CPU, got {jax.devices()}"
    )
    assert len(jax.devices()) == 8, f"expected 8 virtual devices, got {jax.devices()}"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one (MPC_CBF_TEST_GPU=1)")


@pytest.fixture
def gpu():
    """The first GPU device, or a skip. Decided here, when the test runs,
    never while modules are imported or collected."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU: run on the card with MPC_CBF_TEST_GPU=1")
    return devs[0]
