"""Test harness: an 8-fake-device CPU mesh, set up BEFORE jax is imported.

This is the standard JAX substitute for a multi-device rig (SURVEY.md §4
"Distributed (no cluster)"): `--xla_force_host_platform_device_count=8` gives
8 independent CPU devices, so real `Mesh`es and real collectives run without
an accelerator. JAX_PLATFORMS defaults to "cpu" here; tests marked `gpu`
need the card and skip elsewhere — run them on a GPU host with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 fake CPU devices, got {devs}"
    return devs


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU (decided when
    the test runs, never at import)."""
    from poi_tpu import backend

    if backend.platform() != "gpu":
        pytest.skip("needs an NVIDIA GPU: the Triton kernels compile only for the card")
    return jax.devices()[0]
