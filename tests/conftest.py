"""Test config: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding logic is checked without hardware by forcing the
CPU backend to expose 8 devices (the equivalent of testing MPI logic
without a cluster; cf. SURVEY.md section 4). JAX_PLATFORMS is removed
and the platform pinned via jax.config before any test imports jax.
Checks that need an NVIDIA GPU are functions of chip_smoke.py, which
runs them in-process on the card."""

import os

os.environ.pop("JAX_PLATFORMS", None)
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import functools  # noqa: E402

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def pallas_interpreted(monkeypatch):
    """Route every use of the Pallas NUDFT kernel through the Pallas
    interpreter, and let the driver's use_pallas choice see it as
    available: the kernel's own arithmetic, wrapped by the real
    single-device, mesh and driver paths."""
    from prisim_tpu.engine import pallas_nudft
    kernel = pallas_nudft.nudft_pallas
    monkeypatch.setattr(pallas_nudft, "nudft_pallas",
                        functools.partial(kernel, interpret=True))
    monkeypatch.setattr(pallas_nudft, "pallas_available",
                        lambda platform=None: True)
