"""The predict() contract's normalize on the device
(``hand3d_tpu_torch.batching``): uint8 frames copied as uint8 and looked up
in ``normalize_images``' own answers are bit-equal to ``normalize_images``,
on the CPU and, in the ``gpu`` cases, on a card.

This file imports no jax. The ``gpu`` cases need a CUDA device and skip
without one; on a machine with a card run them with ``python -m pytest
-p no:cacheprovider --noconftest -m gpu tests/test_torch_batching.py``. The
estimators' uint8 path against frames normalized on the host is held in
test_torch_export.py, beside its small artifact.
"""

import numpy as np
import pytest
import torch

from hand3d_tpu_torch import batching


def all_256_values():
    return np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, 3)


def chunk_32x240x320():
    return np.random.default_rng(20).integers(0, 256, (32, 240, 320, 3),
                                              dtype=np.uint8)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


@pytest.mark.parametrize("make", [all_256_values, chunk_32x240x320],
                         ids=lambda f: f.__name__)
def test_device_normalize_is_bit_equal_to_normalize_images(make, device):
    frames = make()
    got = batching.to_device_normalized(frames,
                                        batching.uint8_levels(device))
    assert got.device.type == device.type and got.dtype == torch.float32
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  batching.normalize_images(frames))


def test_predict_input_keeps_uint8_and_normalizes_float_on_the_host():
    frames = all_256_values()
    assert batching.predict_input(frames) is frames
    as_float = frames / np.float32(255.0)
    np.testing.assert_array_equal(batching.predict_input(as_float),
                                  as_float - np.float32(0.5))
    done = batching.normalize_images(frames)
    assert batching.predict_input(done, normalized=True) is done
