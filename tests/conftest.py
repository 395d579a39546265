import os
import sys

# Tests run on the CPU backend with a virtual 8-device mesh, so sharding
# paths are exercised without accelerator hardware. Must be set before jax
# is imported anywhere. Tests that need a GPU carry the ``gpu`` marker and
# skip on the CPU (see the ``gpu_device`` fixture); on a GPU host,
# ``VCF2PROT_TESTS_ON_GPU=1 python -m pytest -m gpu tests/`` leaves JAX on
# its default backend so they run.
ON_GPU = os.environ.get("VCF2PROT_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU JAX sees; skips the test when there is none (decided
    at run time, never at import, so every worker collects the same
    tests)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU; on a GPU host run "
                    "VCF2PROT_TESTS_ON_GPU=1 python -m pytest -m gpu tests/")
    return devs[0]
