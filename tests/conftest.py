"""Test configuration: run on a virtual 8-device CPU mesh by default.

The reference's hardware-free test target is OpenCL-on-CPU
(test_clenabled.cc --cpu); ours is the JAX CPU backend with
``xla_force_host_platform_device_count=8`` so the sharding layer's
multi-device paths (ppermute halo exchange, all_to_all X-Engine) execute
for real without accelerators.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and skip elsewhere;
run them on a GPU host with ``JAX_PLATFORMS=cuda python -m pytest -m gpu``.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a ``gpu``-marked test unless JAX's first device is a GPU —
    decided when the test runs, never at import or collection time."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU (JAX found "
                    f"{jax.devices()[0].platform})")
