"""Checks that need the card (marker ``gpu``; skipped where JAX finds no
GPU). ``python chip_smoke.py`` runs the same checks on the card."""

import pytest

from aznet_tpu.utils import gpu_checks


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")


@pytest.mark.gpu
@pytest.mark.parametrize("check", gpu_checks.CHECKS,
                         ids=lambda c: c.__name__)
def test_gpu_check(gpu, check):
    check()
