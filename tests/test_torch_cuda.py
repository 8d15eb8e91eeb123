"""The CUDA kernels against their plain PyTorch versions, on a card.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips (the fixture decides, at run time).
"""

import numpy as np
import pytest
import torch

from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc
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


def _ce_labels(device, shape, seed, all_ignored=False):
    """~10% ignore (255), ~5% in 19..254, the rest valid; or all 255."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 19, shape)
    r = rng.random(shape)
    y = np.where(r < 0.10, 255, y)
    y = np.where((r >= 0.10) & (r < 0.15), rng.integers(19, 255, shape), y)
    if all_ignored:
        y = np.full(shape, 255)
    return torch.from_numpy(y.astype(np.int32)).to(device)


def _ce_value_and_grad(fn, x, labels, out_hw):
    x = x.detach().requires_grad_()
    loss = fn(x, labels, out_hw)
    (grad,) = torch.autograd.grad(loss, x)
    return loss.detach(), grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,out_hw,all_ignored", [
    ((2, 19, 64, 32), (512, 256), False),
    ((1, 19, 7, 13), (37, 50), False),
    ((2, 19, 64, 128), (64, 128), False),
    ((1, 19, 1, 13), (37, 50), False),
    ((1, 19, 1, 1), (3, 5), False),
    ((2, 19, 8, 16), (64, 128), True),
])
def test_fused_ce_equals_plain_version(cuda_device, shape, out_hw,
                                       all_ignored, dtype):
    """Loss within 1e-5 of |loss|; gradient within 1e-4 of its max, plus
    one bf16 ulp (at most 2^-7 |grad|) for bf16 gradients; a second run
    bit-identical; one launch of each kernel per call."""
    x = _logits(cuda_device, shape, 0, False, dtype)
    labels = _ce_labels(cuda_device, (shape[0], *out_hw), 1, all_ignored)
    before = (fc.FWD_LAUNCHES, fc.BWD_LAUNCHES)
    loss, grad = _ce_value_and_grad(fc.cross_entropy_upsampled, x, labels,
                                    out_hw)
    loss2, grad2 = _ce_value_and_grad(fc.cross_entropy_upsampled, x, labels,
                                      out_hw)
    torch.cuda.synchronize()
    assert (fc.FWD_LAUNCHES, fc.BWD_LAUNCHES) == (before[0] + 2,
                                                  before[1] + 2)
    assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
    assert grad.dtype == dtype and loss.dtype == torch.float32
    want, want_grad = _ce_value_and_grad(
        fc.cross_entropy_upsampled_reference, x, labels, out_hw)
    if all_ignored:
        assert loss.item() == 0.0 and not grad.any()
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    bound = 1e-4 * want_grad.float().abs().max()
    if dtype == torch.bfloat16:
        bound = bound + 2.0**-7 * want_grad.float().abs()
    assert bool(((grad.float() - want_grad.float()).abs() <= bound).all())


@pytest.mark.cuda
def test_fused_ce_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros(1, 19, 8, 16, device=cuda_device)
    with pytest.raises(TypeError):  # int64 labels
        fc.cross_entropy_upsampled(
            x, torch.zeros(1, 32, 64, dtype=torch.int64, device=cuda_device),
            (32, 64))
    with pytest.raises(ValueError):  # more classes than the kernel keeps
        fc.cross_entropy_upsampled(
            torch.zeros(1, 40, 8, 16, device=cuda_device),
            torch.zeros(1, 32, 64, dtype=torch.int32, device=cuda_device),
            (32, 64))


def _folded_block(stride, in_c, out_c, dtype, device, seed=0):
    """A CatBottleneck with seeded weights and running statistics away
    from identity, folded for the kernel."""
    from dasemanticsegmentationaml_tpu_torch.models.stdcnet import (
        CatBottleneck)
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_stdc as fs

    gen = torch.Generator().manual_seed(seed)
    block = CatBottleneck(in_c, out_c, 4, stride)
    with torch.no_grad():
        for name, t in block.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif name.endswith("weight") and t.dim() == 4:
                fan_in = t[0].numel()
                t.copy_(torch.randn(t.shape, generator=gen)
                        * (2.0 / fan_in) ** 0.5)
            else:
                t.copy_(0.1 * torch.randn(t.shape, generator=gen)
                        + (1.0 if name.endswith("bn.weight") else 0.0))
    return fs.fold_cat_params(block.to(device).eval(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,in_c,out_c,shape", [
    (1, 64, 128, (2, 64, 19, 37)),     # odd sizes
    (2, 64, 128, (2, 64, 38, 22)),
    (2, 16, 64, (1, 16, 2, 5)),        # H = 2, width below one tile
])
def test_fused_cat_equals_plain_version(cuda_device, stride, in_c, out_c,
                                        shape, dtype):
    """fp32 within 1e-4 of max|plain| (TF32 off for the plain version);
    bf16 within 2e-2 (tests/test_fused_stdc.py:32): both round each
    intermediate to bf16, and a sum in another order can flip a rounding.
    A second run is bit-identical; one launch per call."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_stdc as fs

    fp = _folded_block(stride, in_c, out_c, dtype, cuda_device)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        shape).astype(np.float32)).to(cuda_device, dtype)
    before = (fs.S1_LAUNCHES, fs.S2_LAUNCHES)
    got = fs.fused_cat_bottleneck(x, fp)
    again = fs.fused_cat_bottleneck(x, fp)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = fs.fused_cat_bottleneck_plain(x, fp)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    torch.cuda.synchronize()
    s1, s2 = fs.S1_LAUNCHES - before[0], fs.S2_LAUNCHES - before[1]
    assert (s1, s2) == ((2, 0) if stride == 1 else (0, 2))
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got, again)
    bound = (1e-4 if dtype == torch.float32 else 2e-2) * \
        want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= bound


@pytest.mark.cuda
def test_fused_cat_rejects_what_the_kernel_does_not_take(cuda_device):
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_stdc as fs

    fp = _folded_block(2, 16, 32, torch.bfloat16, cuda_device)
    with pytest.raises(TypeError):  # fp32 input, bf16 weights
        fs.fused_cat_bottleneck(torch.zeros(1, 16, 8, 8, device=cuda_device),
                                fp)
    cpu_fp = _folded_block(2, 16, 32, torch.bfloat16, "cpu")
    with pytest.raises(ValueError):  # weights on another device
        fs.fused_cat_bottleneck(
            torch.zeros(1, 16, 8, 8, device=cuda_device, dtype=torch.bfloat16),
            cpu_fp)


@pytest.mark.cuda
def test_fused_cat_without_a_build_raises(cuda_device, tmp_path, monkeypatch):
    """No fallback on a card: when the kernel cannot be built, a CUDA
    tensor raises instead of taking the plain version."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import build
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_stdc as fs

    fp = _folded_block(1, 16, 32, torch.float32, cuda_device)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_LIBS", {})
    fs._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            fs.fused_cat_bottleneck(
                torch.zeros(1, 16, 8, 8, device=cuda_device), fp)
    finally:
        fs._library.cache_clear()
