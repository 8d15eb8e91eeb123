"""The CUDA kernel against its plain PyTorch version, on a card.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips (the fixture decides, at run time).
"""

import numpy as np
import pytest
import torch

from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _logits(device, shape, seed, tie_heavy, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if tie_heavy:
        x = np.round(x * 4).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tie_heavy", [False, True])
@pytest.mark.parametrize("shape,out_hw", [
    ((2, 19, 64, 128), (512, 1024)),
    ((1, 19, 7, 13), (37, 50)),
    ((2, 19, 64, 128), (64, 128)),
    ((1, 19, 1, 13), (37, 50)),
    ((2, 3, 1, 1), (4, 4)),
])
def test_kernel_equals_plain_version(cuda_device, shape, out_hw, tie_heavy,
                                     dtype):
    x = _logits(cuda_device, shape, 0, tie_heavy, dtype)
    before = ua.LAUNCHES
    got = ua.upsample_argmax(x, out_hw)
    torch.cuda.synchronize()
    assert ua.LAUNCHES == before + 1
    assert got.dtype == torch.int32 and got.shape == (shape[0], *out_hw)
    assert torch.equal(got, ua.upsample_argmax_reference(x, out_hw))


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda_device):
    x = torch.zeros(1, 8, 16, 19, device=cuda_device).permute(0, 3, 1, 2)
    with pytest.raises(ValueError):
        ua.upsample_argmax(x, (32, 64))
