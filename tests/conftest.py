"""Test configuration: the CPU backend with an 8-device virtual mesh.

Tests run on the CPU (``JAX_PLATFORMS=cpu``); multi-device sharding is
validated on 8 virtual CPU devices (SURVEY.md §4).  Tests marked ``gpu``
need an NVIDIA card: they take the ``gpu`` fixture, which skips them on the
CPU, and run on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_device_path.py``.
Only then does this file leave the platform alone.
"""

import os

import pytest

ON_CARD = os.environ.get("JAX_PLATFORMS", "").lower() in ("cuda", "gpu")

if not ON_CARD:
    # XLA_FLAGS is read at backend *initialization* (not import), so this
    # still takes effect as long as no backend has been created yet.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", \
        "tests must run on the virtual CPU mesh"
    assert jax.device_count() == 8


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX has none."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")
    return dev
