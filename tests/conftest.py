import os
import sys

# Tests run on a virtual multi-device CPU mesh: fast, deterministic, and lets
# sharding tests exercise 8 devices without accelerator hardware. The flags
# must be in place before JAX initialises its backend.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import pytest

# JAX_PLATFORMS=cuda runs the card-only tests (marked ``gpu``) on a GPU
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from pybnesian_tpu.runtime.config import enable_compile_cache  # noqa: E402

enable_compile_cache()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU. Decided here, at run time, and never at
    import or collection time: every xdist worker must collect the same
    tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu")
    return jax.devices()[0]
