"""The CUDA kernels against their plain PyTorch versions, on a card.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips (the fixture decides, at run time).
"""

import contextlib

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


def _nonfinite(x):
    """NaN, +inf and -inf at set places, one source pixel all NaN and one
    all -inf (as tests/test_torch_upsample_argmax_plan.py::nonfinite)."""
    b, c, h, w = x.shape
    x[0, min(3, c - 1), h // 2, w // 3] = np.nan
    x[-1, c // 2, 0, w - 1] = np.inf
    x[0, c - 1, h - 1, 0] = -np.inf
    x[-1, :, h - 1, w // 2] = np.nan
    x[0, :, 0, w // 2] = -np.inf
    return x


def _logits(device, shape, seed, kind, dtype):
    """Random-normal logits; "ties": rounded to quarters, so classes tie;
    "nonfinite": with NaN and infs at set places."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 4).astype(np.float32)
    elif kind == "nonfinite":
        x = _nonfinite(x)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["normal", "ties", "nonfinite"])
@pytest.mark.parametrize("shape,out_hw", [
    ((2, 19, 64, 128), (512, 1024)),
    ((1, 19, 7, 13), (37, 50)),
    ((2, 19, 64, 128), (64, 128)),
    ((1, 19, 1, 13), (37, 50)),
    ((2, 3, 1, 1), (4, 4)),
    ((1, 19, 64, 128), (512, 1024)),   # B = 1, the CLI's eval batch
    ((1, 19, 37, 50), (7, 13)),        # downsampling: empty segments
    ((1, 19, 5, 1), (9, 7)),           # w = 1: one segment a row
    ((2, 3, 16, 32), (128, 256)),      # C = 3, the generic instance
    ((2, 32, 16, 32), (128, 256)),     # C = 32, one generic chunk
    ((1, 40, 9, 11), (45, 61)),        # C = 40, two chunks
    ((2, 19, 13, 16), (100, 120)),     # ragged last band
    ((1, 19, 3, 1000), (5, 1100)),     # w > 256: one row a band
    ((1, 19, 2, 8), (2, 12500)),       # rows too wide to stage: stored straight
])
def test_kernel_equals_plain_version(cuda_device, shape, out_hw, kind,
                                     dtype):
    """Bit-identical to the plain version (torch.argmax: the first NaN,
    otherwise the first of the largest); one launch a call."""
    x = _logits(cuda_device, shape, 0, kind, dtype)
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


def _ce_labels(device, shape, seed, all_ignored=False, num_classes=19):
    """~10% ignore (255), ~5% in C..254, the rest valid; or all 255."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, shape)
    r = rng.random(shape)
    y = np.where(r < 0.10, 255, y)
    y = np.where((r >= 0.10) & (r < 0.15),
                 rng.integers(num_classes, 255, shape), y)
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
    ((1, 19, 37, 50), (7, 13), False),      # downsampling: rows without taps
    ((1, 19, 2, 16), (64, 128), False),     # h = 2, one band
    ((1, 19, 128, 64), (1024, 512), False),  # B = 1: few blocks
    ((2, 3, 16, 32), (128, 256), False),    # C = 3, the generic path
    ((2, 32, 16, 32), (128, 256), False),   # C = 32
    ((2, 19, 13, 16), (100, 120), False),   # band edges between output rows
    ((1, 19, 5, 1), (9, 1), False),         # w = 1
])
def test_fused_ce_equals_plain_version(cuda_device, shape, out_hw,
                                       all_ignored, dtype):
    """Loss within 1e-5 of |loss|; gradient within 1e-4 of its max, plus
    one bf16 ulp (at most 2^-7 |grad|) for bf16 gradients; a second run
    bit-identical; one launch of each kernel per call."""
    x = _logits(cuda_device, shape, 0, "normal", dtype)
    labels = _ce_labels(cuda_device, (shape[0], *out_hw), 1, all_ignored,
                        shape[1])
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


def _pinned_batch(seed, n=2, h=64, w=128):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.integers(0, 256, (n, h, w, 3),
                                           dtype=np.uint8)).pin_memory()
    labels = torch.from_numpy(rng.integers(0, 35, (n, h, w),
                                           dtype=np.uint8)).pin_memory()
    return images, labels


@contextlib.contextmanager
def _sync_debug(mode):
    """``torch.cuda.set_sync_debug_mode`` for a block, restored after."""
    saved = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(saved)


@pytest.mark.cuda
def test_prepare_batch_does_not_wait_for_the_stream(cuda_device):
    """From pinned host tensors, ``prepare_batch`` (GTA5's remap included)
    only enqueues work once its per-device constants exist: no call in it
    synchronizes."""
    from dasemanticsegmentationaml_tpu_torch.data.labels import train_id_lut
    from dasemanticsegmentationaml_tpu_torch.data.pipeline import (
        prepare_batch)

    images, labels = _pinned_batch(0)
    prepare_batch(images, labels, device=cuda_device, remap=True)
    with _sync_debug("error"):
        for _ in range(3):
            x, y = prepare_batch(images, labels, device=cuda_device,
                                 remap=True, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert x.shape == (2, 3, 64, 128) and x.dtype == torch.bfloat16
    want = train_id_lut()[labels.numpy()].astype(np.int32)
    np.testing.assert_array_equal(y.cpu().numpy(), want)


@pytest.mark.cuda
def test_evaluate_reads_back_only_at_the_end(cuda_device):
    """The eval loop (prefetch, model, kernel, histogram, counts) runs in
    sync-debug mode "error": nothing is read back per batch. Its counts
    give ``evaluate``'s precision and mIoU, which reads back once."""
    from dasemanticsegmentationaml_tpu_torch.data.pipeline import (
        prepare_batch)
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        build_bisenet)
    from dasemanticsegmentationaml_tpu_torch.ops.metrics import per_class_iou
    from dasemanticsegmentationaml_tpu_torch.train import evaluate as ev

    model = build_bisenet(19, device=cuda_device,
                          generator=torch.Generator().manual_seed(0)).eval()
    batches = [_pinned_batch(i) for i in range(3)]

    def prepare(batch):
        return prepare_batch(*batch, device=cuda_device, remap=True,
                             dtype=torch.bfloat16)

    kw = dict(prepare=prepare, device=cuda_device,
              amp_dtype=torch.bfloat16)
    ev.eval_counts(model, batches, 19, **kw)  # builds the kernel, the taps
    before = ua.LAUNCHES
    with _sync_debug("error"):
        hist, correct, total = ev.eval_counts(model, batches, 19, **kw)
    assert ua.LAUNCHES == before + len(batches)
    precision, miou = ev.evaluate(model, batches, 19, print_results=False,
                                  **kw)
    assert total == 3 * 2 * 64 * 128 and int(hist.sum()) <= total
    assert precision == int(correct.item()) / total
    assert miou == float(np.mean(per_class_iou(hist.cpu()).numpy()))


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
    (1, 64, 128, (2, 64, 23, 41)),     # ragged last 64/128-pixel tile
    (2, 64, 128, (1, 64, 29, 45)),     # both ways; ragged x1 rows
    (1, 16, 32, (2, 16, 12, 20)),      # (16, 8, 4, 4): below the MMA's
    (2, 16, 32, (1, 16, 15, 9)),       # 64 output and 16 input channels
    (1, 24, 64, (1, 24, 7, 33)),       # (32, 16, 8, 8), Cin 24
    (2, 40, 64, (2, 40, 18, 10)),
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


def _bf16_buffer(device, n, seed=0):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)


#: buffer sizes in bf16 values: one 16-byte vector, a ragged last chunk
#: and tile, fewer chunks than SMs, more chunks than SMs, and copy_direct's
#: uneven spans (more tiles than its grid, not a multiple of it) with a
#: ragged last tile (1786 and 4014 whole tiles of 1024 vectors)
_COPY_SIZES = [8, 8 * 1000 + 8, 3 * 4096 + 24, 4 * 1024 * 1024 + 8,
               8 * (1024 * 1786 + 77), 8 * (1024 * 4014 + 1023)]


def _copy_launches():
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import copy_probe as cp

    return (cp.BLOCK_LAUNCHES, cp.DIRECT_LAUNCHES, dict(cp.BOUNCE_LAUNCHES))


@pytest.mark.cuda
@pytest.mark.parametrize("n", _COPY_SIZES)
@pytest.mark.parametrize("kernel", ["block", "direct", "bounce2", "bounce8"])
def test_copy_kernels_equal_plain_version(cuda_device, kernel, n):
    """Bit-identical to ``x.clone()``, into a new tensor and into ``out``;
    the kernel's counter rises by the two calls."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import copy_probe as cp

    fn = {"block": cp.copy_block, "direct": cp.copy_direct,
          "bounce2": lambda x, out=None: cp.copy_bounce(x, out, n_slots=2),
          "bounce8": lambda x, out=None: cp.copy_bounce(x, out, n_slots=8)
          }[kernel]
    x = _bf16_buffer(cuda_device, n)
    out = torch.full_like(x, float("nan"))
    before = _copy_launches()
    got = fn(x)
    into = fn(x, out)
    torch.cuda.synchronize()
    after = _copy_launches()
    want = cp.copy_plain(x)
    assert into is out
    for t in (got, into):
        assert torch.equal(t.view(torch.int16), want.view(torch.int16))
    rose = {"block": after[0] - before[0], "direct": after[1] - before[1],
            "bounce2": after[2][2] - before[2][2],
            "bounce8": after[2][8] - before[2][8]}
    assert rose == {k: (2 if k == kernel else 0) for k in rose}


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots,stores", [(2, 1)] + [(8, s)
                                                       for s in range(1, 8)])
def test_copy_bounce_chunk_sweep(cuda_device, n_slots, stores):
    """Every ring of the probe's sweep with this split (each chunk, 1 and 2
    blocks per SM, static and dynamic), bit-identical
    to ``x.clone()`` into a new tensor and into ``out``: at a ragged last
    chunk and at fewer chunks than blocks."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import copy_probe as cp
    from dasemanticsegmentationaml_tpu_torch.tools import probe_copy

    rings = [r for r in probe_copy.rings(n_slots) if r.stores == stores]
    assert rings
    for n in (3 * 1024 * 1024 + 8, 8 * 1000 + 8):
        x = _bf16_buffer(cuda_device, n, seed=1)
        out = torch.empty_like(x)
        for ring in rings:
            out.fill_(float("nan"))
            got = cp.copy_bounce(x, n_slots=n_slots, **ring._asdict())
            into = cp.copy_bounce(x, out, n_slots=n_slots, **ring._asdict())
            torch.cuda.synchronize()
            for t in (got, into):
                assert torch.equal(t.view(torch.int16), x.view(torch.int16)), \
                    (n, ring)
            # each dynamic launch leaves its counters zeroed for the next
            assert not cp._claims(x.device).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", _COPY_SIZES)
def test_copy_direct_variants(cuda_device, n):
    """copy_direct at every span length the probe sweeps (pipelined when
    a block has more than one tile), bit-identical to ``x.clone()``."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import copy_probe as cp
    from dasemanticsegmentationaml_tpu_torch.tools import probe_copy

    x = _bf16_buffer(cuda_device, n, seed=2)
    out = torch.empty_like(x)
    for tiles_per_block in probe_copy.DIRECT_TILES + (3, 8):
        out.fill_(float("nan"))
        cp.copy_direct(x, out, tiles_per_block=tiles_per_block)
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int16), x.view(torch.int16)), \
            tiles_per_block


@pytest.mark.cuda
def test_copy_kernels_reject_what_they_do_not_take(cuda_device):
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import copy_probe as cp

    x = _bf16_buffer(cuda_device, 64)
    for fn in (cp.copy_block, cp.copy_direct, cp.copy_bounce):
        with pytest.raises(ValueError):  # 14 bytes
            fn(x[:7])
        with pytest.raises(ValueError):  # 2 bytes off a 16-byte boundary
            fn(x[1:9])
        with pytest.raises(ValueError):  # not contiguous
            fn(x.view(8, 8).t())
        with pytest.raises(ValueError):  # out overlaps x
            fn(x[:32], x[8:40])
        with pytest.raises(ValueError):  # out of another dtype
            fn(x, torch.empty(64, device=cuda_device))
        with pytest.raises(TypeError):
            fn(torch.zeros(16, dtype=torch.bool, device=cuda_device))
    with pytest.raises(ValueError):  # no such ring
        cp.copy_bounce(x, n_slots=4)
    with pytest.raises(ValueError):  # the ring does not fit 227 KB
        cp.copy_bounce(x, n_slots=8, chunk_bytes=32 * 1024)


@pytest.mark.cuda
def test_copy_without_a_build_raises(cuda_device, tmp_path, monkeypatch):
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import build
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import copy_probe as cp

    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_LIBS", {})
    cp._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cp.copy_bounce(_bf16_buffer(cuda_device, 64))
    finally:
        cp._library.cache_clear()


_ROLL_SHIFTS = [0, 1, -1, 2, 3, 7, 63, 127, 128, 129, -300]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16, torch.int16])
@pytest.mark.parametrize("rows,cols", [(8, 128), (1, 64), (8, 256),
                                       (3, 520), (5, 8)])
def test_tile_roll_equals_plain_version(cuda_device, rows, cols, dtype):
    """Bit-identical to the slices + cat version at every shift, C - 1, C
    and C + 1 included; one launch per call. 520 is no multiple of 32
    vectors; rows of 8 values are one or two vectors."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import tile_roll as tr

    x = torch.from_numpy(np.random.default_rng(0).integers(
        -3000, 3000, (rows, cols)).astype(np.float32)).to(cuda_device, dtype)
    shifts = _ROLL_SHIFTS + [cols - 1, cols, cols + 1]
    before = tr.LAUNCHES
    for shift in shifts:
        got = tr.tile_roll(x, shift)
        want = tr.tile_roll_plain(x, shift)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == x.shape
        assert torch.equal(got, want), shift
    assert tr.LAUNCHES == before + len(shifts)


@pytest.mark.cuda
def test_tile_roll_rejects_what_it_does_not_take(cuda_device):
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import tile_roll as tr

    with pytest.raises(ValueError):  # 14-byte rows
        tr.tile_roll(torch.zeros(2, 7, dtype=torch.bfloat16,
                                 device=cuda_device), 1)
    with pytest.raises(ValueError):  # 148-byte rows of a 32-bit type
        tr.tile_roll(torch.zeros(3, 37, device=cuda_device), 1)
    with pytest.raises(ValueError):  # 2 bytes off a 16-byte boundary
        tr.tile_roll(torch.zeros(33, dtype=torch.int16,
                                 device=cuda_device)[1:].view(2, 16), 1)
    with pytest.raises(ValueError):  # 4 bytes off a 16-byte boundary
        tr.tile_roll(torch.zeros(36, device=cuda_device)[1:33].view(2, 16), 1)
    with pytest.raises(TypeError):
        tr.tile_roll(torch.zeros(2, 8, dtype=torch.float64,
                                 device=cuda_device), 1)
    with pytest.raises(ValueError):
        tr.tile_roll(torch.zeros(2, 8, 8, device=cuda_device), 1)
