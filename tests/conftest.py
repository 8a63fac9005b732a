"""Test harness: force a virtual 8-device CPU platform BEFORE backend init.

Multi-device sharding paths run in CI without several accelerators via
``--xla_force_host_platform_device_count=8`` (SURVEY.md §4). Set
``PSIM_TEST_REAL_DEVICES=1`` to run the suite on whatever hardware is
attached instead — the only way the ``gpu``-marked tests run.
"""

import os

import pytest

if not os.environ.get("PSIM_TEST_REAL_DEVICES"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``@pytest.mark.gpu`` tests unless JAX's default backend is a
    GPU: their kernels have no compiled form anywhere else. Decided per
    test, at run time, so collection never touches a backend."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs a GPU: compiled Triton kernels at full width")
