import os

import pytest

# Tests run on a virtual 8-device CPU mesh, so sharding logic is checked
# without cards.  LOCITYPER_TEST_GPU=1 keeps the real backend instead and
# runs the tests marked `gpu` on the card:
#     LOCITYPER_TEST_GPU=1 python -m pytest tests/ -m gpu
# (jax.config is set after import as well: the environment variable alone
# does not override a platform pinned elsewhere.)
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("LOCITYPER_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")

from locityper_tpu.utils.malloc import tune_host_allocator  # noqa: E402

tune_host_allocator()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skipped elsewhere)")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skips `gpu`-marked tests unless JAX runs on a GPU."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU (LOCITYPER_TEST_GPU=1 on a card)")
