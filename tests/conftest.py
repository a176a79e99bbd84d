import os

# Tests run on a virtual 8-device CPU mesh; f64 is enabled so parity tests can
# match the reference's f64 maths exactly. The platform is pinned through the
# config before any backend is initialised. Tests marked `gpu` need an NVIDIA
# card and run only where JAX finds one (the `gpu_device` fixture).
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first NVIDIA device, or a skip where JAX finds none. Decided here,
    at run time, never while test modules are imported."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu)")
