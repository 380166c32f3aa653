"""Test configuration: a virtual 8-device CPU platform.

The suite runs on the CPU unless JAX_PLATFORMS names other platforms;
sharding tests run on a virtual 8-device CPU mesh. Tests marked ``gpu``
need a GPU: the ``gpu_device`` fixture skips them elsewhere. On a card they
run as ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip. Decided when the test runs, never while
    modules are imported, so every worker collects the same tests."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (run on the card: see chip_smoke.py)")
    return devices[0]


@pytest.fixture
def cuda_model(monkeypatch):
    """Route as on a GPU, with the CUDA kernel's launches replaced by its
    exact CPU model (cuda_sweep.model_launch): the planners' and library's
    GPU path, end to end, on the CPU."""
    from epic_tpu.solver import cuda_sweep, route

    monkeypatch.setattr(route, "platform", lambda: "gpu")
    monkeypatch.setattr(cuda_sweep, "_ffi_launch", cuda_sweep.model_launch)
    jax.clear_caches()
    yield
    jax.clear_caches()
