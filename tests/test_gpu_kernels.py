"""chip_smoke's kernel comparisons: each kernel jitted on the GPU and on
the CPU in one process, at the engine's widths. Needs an NVIDIA GPU:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu_kernels.py
"""

import jax
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def devices():
    try:
        gpu = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX: these checks compare the card "
                    "with the CPU")
    return gpu, jax.devices("cpu")[0]


def test_window_extraction_exact(devices):
    assert chip_smoke.check_extraction(devices) > 0


def test_direct_tracker_gpu_matches_cpu(devices):
    chip_smoke.check_direct(*devices)


def test_window_ba_gpu_matches_cpu(devices):
    chip_smoke.check_window_ba(*devices)


def test_photometric_ba_gpu_matches_cpu(devices):
    chip_smoke.check_photo_ba(*devices)
