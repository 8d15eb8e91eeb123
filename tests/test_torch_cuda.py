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
    """From pinned host tensors, ``prepare_batch`` (GTA5's remap included,
    and each augmentation menu with its labels warped) only enqueues work
    once its per-device constants exist: no call in it synchronizes, the
    menus' draws on the card and their 8x8 solves included."""
    from dasemanticsegmentationaml_tpu_torch.data.augment import (
        batch_generator)
    from dasemanticsegmentationaml_tpu_torch.data.labels import train_id_lut
    from dasemanticsegmentationaml_tpu_torch.data.pipeline import (
        prepare_batch)

    images, labels = _pinned_batch(0)
    menus = (None, "CS-HF", "H-RP", "B-GS-R")

    def prepare(aug_type, it):
        generator = (None if aug_type is None
                     else batch_generator(0, 0, it, cuda_device))
        return prepare_batch(images, labels, device=cuda_device, remap=True,
                             dtype=torch.bfloat16, aug_type=aug_type,
                             generator=generator, augment_labels=True)

    for aug_type in menus:
        prepare(aug_type, 0)
    with _sync_debug("error"):
        out = {aug_type: [prepare(aug_type, it) for it in range(3)]
               for aug_type in menus}
    torch.cuda.synchronize()
    x, y = out[None][-1]
    assert x.shape == (2, 3, 64, 128) and x.dtype == torch.bfloat16
    want = train_id_lut()[labels.numpy()].astype(np.int32)
    np.testing.assert_array_equal(y.cpu().numpy(), want)
    train_ids = set(train_id_lut().tolist())
    for aug_type in menus[1:]:
        for x, y in out[aug_type]:
            assert x.shape == (2, 3, 64, 128) and x.dtype == torch.bfloat16
            assert bool(torch.isfinite(x.float()).all())
            assert set(torch.unique(y).tolist()) <= train_ids


#: the training path's bound (tests/test_torch_augment.py): images within
#: 1e-2 on the 0-255 scale, labels identical, each on at least this share
#: of the pixels; the rest are float32 floor and round ties of the warp
AUG_SHARE = 0.999


def _aug_batch(seed, n=4, h=64, w=128):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (n, h, w, 3),
                                          dtype=np.uint8)).float(),
            torch.from_numpy(rng.integers(0, 35, (n, h, w), dtype=np.uint8)))


@pytest.mark.cuda
@pytest.mark.parametrize("aug_type", ["CS-HF", "H-RP", "B-GS-R"])
def test_augment_on_card_equals_cpu(cuda_device, aug_type):
    """Each menu on the card against the same function on the CPU with
    the same explicit parameters. Training path (a batch, labels warped
    too): within ``AUG_SHARE``. Pil-exact replay (one sample): CS-HF and
    B-GS-R bit-identical; H-RP on at most 1e-3 of the pixels, by at most
    1, with identical labels; the card's 8x8 solves within 1e-4 of the
    CPU's (relative to the largest coefficient)."""
    from dasemanticsegmentationaml_tpu_torch.data import augment as aug
    from dasemanticsegmentationaml_tpu_torch.data import host_augment

    imgs, labels = _aug_batch(0)
    n, h, w = labels.shape
    params = aug.sample_params(aug_type, n, h, w,
                               torch.Generator().manual_seed(1),
                               apply_prob=0.75)
    on_card = {k: v.to(cuda_device) for k, v in params.items()}
    want = aug.apply_params(imgs, labels, aug_type, params,
                            augment_labels=True)
    got = aug.apply_params(imgs.to(cuda_device), labels.to(cuda_device),
                           aug_type, on_card, augment_labels=True)
    img_share = ((got[0].cpu() - want[0]).abs() <= 1e-2).float().mean()
    label_share = (got[1].cpu() == want[1]).float().mean()
    assert img_share >= AUG_SHARE and label_share >= AUG_SHARE, (
        img_share, label_share)
    if aug_type == "H-RP":
        coeffs = aug.perspective_coeffs(on_card["start"], on_card["end"])
        err = (coeffs.cpu() - params["coeffs"]).abs().max(dim=1).values
        scale = params["coeffs"].abs().max(dim=1).values
        assert bool((err <= 1e-4 * scale).all()), (err, scale)

    for i in range(n):
        p = host_augment.sample_params(aug_type, host_augment.rng_for(2, 0, i),
                                       h, w, apply_prob=1.0)
        want = aug.apply_family_with_params(imgs[i], labels[i], aug_type, p,
                                            augment_labels=True)
        got = aug.apply_family_with_params(
            imgs[i].to(cuda_device), labels[i].to(cuda_device), aug_type, p,
            augment_labels=True)
        d = (got[0].cpu() - want[0]).abs()
        if aug_type == "H-RP":
            assert (d > 0).float().mean() <= 1e-3 and d.max() <= 1.0, (
                i, (d > 0).float().mean(), d.max())
        else:
            assert not d.any(), (i, d.max())
        assert torch.equal(got[1].cpu(), want[1]), i


def _eval_launches(ev):
    """upsample_argmax's launches so far: its wrapper's count, less the
    calls that only recorded into a captured graph, plus the graph
    replays' (``train/evaluate.py``)."""
    return (ua.LAUNCHES - ev.CAPTURED_LAUNCHES["upsample_argmax"]
            + ev.REPLAYED_LAUNCHES["upsample_argmax"])


@pytest.mark.cuda
@pytest.mark.parametrize("scan_window", [0, 2])
def test_evaluate_reads_back_only_at_the_end(cuda_device, scan_window):
    """The eval loop (prefetch, model, kernel, histogram, counts) runs in
    sync-debug mode "error": nothing is read back per batch, with the
    fetch watchdog's thread, and with a window of 2 replayed from the
    graph the first call captured (two batches a replay, the third
    eager). Its counts give ``evaluate``'s precision and mIoU, which reads
    back once."""
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
              amp_dtype=torch.bfloat16, scan_window=scan_window,
              graphs=ev.EvalGraphs())
    # builds the kernel, the taps (and captures the window's graph)
    ev.eval_counts(model, batches, 19, **kw)
    before, replays = _eval_launches(ev), ev.GRAPH_REPLAYS
    with _sync_debug("error"):
        hist, correct, total = ev.eval_counts(model, batches, 19, **kw)
    assert _eval_launches(ev) == before + len(batches)
    assert ev.GRAPH_REPLAYS == replays + (1 if scan_window else 0)
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


def _write_cityscapes(root, mode, n, size=(64, 128), seed=0):
    """tests/test_torch_eval.py::_mk_cityscapes's layout (that module
    imports JAX)."""
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)
    for top in ("images", "gtFine"):
        os.makedirs(os.path.join(root, top, mode, "city"), exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)
                        ).save(os.path.join(root, "images", mode, "city",
                                            f"c_{i:03d}.png"))
        Image.fromarray(rng.integers(0, 19, size, dtype=np.uint8), mode="L"
                        ).save(os.path.join(root, "gtFine", mode, "city",
                                            f"c_{i:03d}_labelTrainIds.png"))


@pytest.mark.cuda
def test_resumed_run_on_card_matches_straight_run(cuda_device, tmp_path,
                                                  monkeypatch):
    """Supervised, fp32 (TF32 off), 64x128, batch 2, 4 epochs of 2 steps
    with --iter_size 2. The straight run keeps a copy of its own epoch-2
    state; --resume from it runs epoch 3 again from the very same state,
    restored bit for bit. The card's backward does not sum in a fixed
    order, so the epoch is held to the card-step bounds (PERF.md §2):
    its loss within rtol 1e-4 of the straight run's, its final weights
    within 0.02 of the epoch's update in global l2."""
    import json
    import os
    import shutil

    from dasemanticsegmentationaml_tpu_torch import cli
    from dasemanticsegmentationaml_tpu_torch.utils import state_io

    root = str(tmp_path / "cs")
    _write_cityscapes(root, "train", 4)
    _write_cityscapes(root, "val", 2, seed=1)
    argv = ["--root", root, "--crop_height", "64", "--crop_width", "128",
            "--batch_size", "2", "--eval_batch_size", "2",
            "--num_epochs", "4", "--max_steps_per_epoch", "2",
            "--iter_size", "2", "--validation_step", "1",
            "--checkpoint_step", "1", "--num_workers", "1",
            "--dtype", "float32", "--tensorboard", "False", "--cuda", "0"]
    kept = str(tmp_path / "kept")
    write_marker = state_io.write_epoch_marker

    def keeping(directory, epoch):
        write_marker(directory, epoch)
        if epoch == 2:
            shutil.copytree(directory, kept, dirs_exist_ok=True)

    runs = {}
    for kind in ("straight", "resumed"):
        save = str(tmp_path / kind)
        log = str(tmp_path / f"{kind}.jsonl")
        run = argv + ["--save_model_path", save, "--jsonl_log", log]
        if kind == "straight":
            monkeypatch.setattr(state_io, "write_epoch_marker", keeping)
        else:
            run += ["--resume", kept]
        cli.main(run)
        monkeypatch.undo()
        with open(log) as f:
            rows = [json.loads(line) for line in f]
        runs[kind] = (rows, state_io.restore_train_state(
            os.path.join(save, "state"), "latest")["model"])
    (rows_a, final_a), (rows_b, final_b) = runs["straight"], runs["resumed"]
    assert [r["epoch"] for r in rows_b] == [3]
    np.testing.assert_allclose(rows_b[0]["loss"], rows_a[3]["loss"],
                               rtol=1e-4)
    start = state_io.restore_train_state(kept, "latest")["model"]
    diff = upd = 0.0
    for key, a in final_a.items():
        if key.endswith(("running_mean", "running_var",
                         "num_batches_tracked")):
            continue
        diff += float((final_b[key].double() - a.double()).pow(2).sum())
        upd += float((a.double() - start[key].double()).pow(2).sum())
    assert upd > 0 and (diff / upd) ** 0.5 < 0.02


def _seeded_eval_model(device, seed=0):
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        build_bisenet)

    return build_bisenet(19, device=device,
                         generator=torch.Generator().manual_seed(seed)).eval()


def _device_batches(device, n, seed=0, b=2, h=64, w=128):
    """``n`` prepared bf16 batches of ``b`` on ``device`` and a tail of 1."""
    from dasemanticsegmentationaml_tpu_torch.data.pipeline import (
        prepare_batch)

    out = []
    for i in range(n + 1):
        images, labels = _pinned_batch(seed + i, n=b if i < n else 1, h=h,
                                       w=w)
        out.append(prepare_batch(images, labels, device=device, remap=True,
                                 dtype=torch.bfloat16))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_window_graph_replay_equals_eager(cuda_device, quantized):
    """Nine batches of 2 and a tail of 1, bf16: windows of 4 (two replays,
    a leftover and the tail eager) and 9 (one replay) count what the
    eager loop counts, bit for bit; also for the int8 model of
    ``head_ch`` (its blocks captured into the graph too)."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic
    from dasemanticsegmentationaml_tpu_torch.ops.quantize import (
        PRESET_FILTERS, quantize_model)
    from dasemanticsegmentationaml_tpu_torch.train import evaluate as ev

    model = _seeded_eval_model(cuda_device)
    batches = _device_batches(cuda_device, 9)
    if quantized:
        model, _ = quantize_model(model, [x for x, _ in batches[:2]],
                                  filter_fn=PRESET_FILTERS["head_ch"],
                                  amp_dtype=torch.bfloat16)
    kw = dict(prepare=lambda b: b, device=cuda_device,
              amp_dtype=torch.bfloat16, graphs=ev.EvalGraphs())
    want = ev.eval_counts(model, batches, 19, **kw)
    for k in (4, 9):
        replays, int8 = ev.GRAPH_REPLAYS, ev.REPLAYED_LAUNCHES["int8_conv"]
        got = ev.eval_counts(model, batches, 19, scan_window=k, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2] == want[2]
        assert ev.GRAPH_REPLAYS == replays + 9 // k
        if quantized:
            assert ev.REPLAYED_LAUNCHES["int8_conv"] == int8 + 3 * k * (9 // k)
    assert ic.LAUNCHES > 0 or not quantized


@pytest.mark.cuda
def test_window_replays_the_weights_after_an_optimizer_step(cuda_device):
    """Validation inside training: a window captured before an SGD step
    replays the stepped weights and BN statistics (read in place) and
    counts what eager counts after the step."""
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.train import evaluate as ev
    from dasemanticsegmentationaml_tpu_torch.train.optim import make_optimizer
    from dasemanticsegmentationaml_tpu_torch.train.supervised import (
        make_train_step)

    model = _seeded_eval_model(cuda_device)
    batches = _device_batches(cuda_device, 4)
    kw = dict(prepare=lambda b: b, device=cuda_device,
              amp_dtype=torch.bfloat16, graphs=ev.EvalGraphs())
    before = ev.eval_counts(model, batches, 19, scan_window=2, **kw)
    captures = ev.GRAPH_CAPTURES
    optimizer = make_optimizer("sgd", trainable_parameters(model), 0.1,
                               momentum=0.9, weight_decay=1e-4)
    step = make_train_step(model, optimizer, amp_dtype=torch.bfloat16)
    model.train()
    for images, labels in batches[:2]:
        step(images, labels)
    model.eval()
    got = ev.eval_counts(model, batches, 19, scan_window=2, **kw)
    assert ev.GRAPH_CAPTURES == captures, "the window was captured again"
    want = ev.eval_counts(model, batches, 19, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(want[0], before[0]), "the step changed nothing"


@pytest.mark.cuda
def test_failed_capture_raises(cuda_device):
    """A step that cannot be captured (it reads a value back) raises on
    the card; it never continues eagerly."""
    from dasemanticsegmentationaml_tpu_torch.train import evaluate as ev

    class ReadsBack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 19, 1).to(cuda_device)

        def features(self, x):
            y = self.conv(x)
            if y.abs().max().item() < 0:
                y = -y
            return y, y, y

    batches = _device_batches(cuda_device, 2)
    with pytest.raises(RuntimeError):
        ev.eval_counts(ReadsBack().eval(), batches, 19,
                       prepare=lambda b: b, device=cuda_device,
                       scan_window=2)


@pytest.mark.cuda
def test_prefetch_fetches_on_the_consumers_stream(cuda_device):
    """The fetch watchdog's thread makes the consumer's current stream its
    own, so a batch's preparation is ordered before the step."""
    from dasemanticsegmentationaml_tpu_torch.data.pipeline import (
        device_prefetch)

    side = torch.cuda.Stream(cuda_device)
    seen = []

    def batches():
        for i in range(3):
            seen.append(torch.cuda.current_stream(cuda_device))
            yield torch.full((4,), i, device=cuda_device)

    with torch.cuda.stream(side):
        out = list(device_prefetch(batches(), transfer_timeout=10.0,
                                   device=cuda_device))
    torch.cuda.synchronize()
    assert [int(x[0]) for x in out] == [0, 1, 2]
    assert all(s == side for s in seen)


#: the int8 kernel's cases: (N, Cin, H, W, Cout, kernel, stride, padding);
#: BiSeNet's blocks (conv_out.conv, the stem pair, a 1x1, conv_avg on the
#: pooled 1x1 map, a head of 64) and edges (Cin not a multiple of 32,
#: Cout below a tile, a ragged pixel tile)
INT8_CASES = (
    (2, 256, 16, 32, 256, 3, 1, 1),
    (2, 3, 64, 128, 32, 3, 2, 1),
    (2, 32, 32, 64, 64, 3, 2, 1),
    (2, 384, 16, 32, 256, 1, 1, 0),
    (2, 1024, 1, 1, 128, 1, 1, 0),
    (2, 128, 16, 32, 64, 3, 1, 1),
    (1, 40, 9, 13, 19, 3, 1, 1),
    (3, 64, 7, 11, 96, 1, 1, 0),
)
#: the 24 distinct shapes of the 35 int8 blocks of BiSeNet-STDC813 under
#: --quantize_filter all at batch 8, 512x1024 (tests/test_torch_int8_conv.py
#: holds their plans): the stem, features.1, the CatBottlenecks' convs,
#: the context path's and the heads'
INT8_ALL_SHAPES = (
    (8, 3, 512, 1024, 32, 3, 2, 1),
    (8, 32, 256, 512, 64, 3, 2, 1),
    (8, 64, 128, 256, 128, 1, 1, 0),
    (8, 128, 64, 128, 64, 3, 1, 1),
    (8, 64, 64, 128, 32, 3, 1, 1),
    (8, 32, 64, 128, 32, 3, 1, 1),
    (8, 256, 64, 128, 128, 1, 1, 0),
    (8, 256, 64, 128, 256, 1, 1, 0),
    (8, 256, 32, 64, 128, 3, 1, 1),
    (8, 128, 32, 64, 64, 3, 1, 1),
    (8, 64, 32, 64, 64, 3, 1, 1),
    (8, 512, 32, 64, 256, 1, 1, 0),
    (8, 512, 32, 64, 512, 1, 1, 0),
    (8, 512, 16, 32, 256, 3, 1, 1),
    (8, 256, 16, 32, 128, 3, 1, 1),
    (8, 128, 16, 32, 128, 3, 1, 1),
    (8, 1024, 16, 32, 512, 1, 1, 0),
    (8, 1024, 1, 1, 128, 1, 1, 0),
    (8, 1024, 16, 32, 128, 3, 1, 1),
    (8, 128, 32, 64, 128, 3, 1, 1),
    (8, 512, 32, 64, 128, 3, 1, 1),
    (8, 128, 64, 128, 128, 3, 1, 1),
    (8, 384, 64, 128, 256, 1, 1, 0),
    (8, 256, 64, 128, 256, 3, 1, 1),
)
INT8_DTYPES = [(torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32),
               (torch.float32, torch.bfloat16)]


def _int8_inputs(device, case, in_dtype, seed, nonfinite=False):
    """Activations (std 2; with NaN, +-inf and values past the scale at
    set places when ``nonfinite``), int8 weights, per-channel scales and
    biases, and the inverse scale (127 over the finite absmax)."""
    n, cin, h, w, cout, ks, _, _ = case
    rng = np.random.default_rng(seed)
    xn = (rng.standard_normal((n, cin, h, w)) * 2).astype(np.float32)
    scale = np.abs(xn).max()
    if nonfinite:
        flat = xn.reshape(-1)
        flat[::5] = np.nan
        flat[1::7] = np.inf
        flat[2::11] = -np.inf
        flat[3::13] = 4 * scale
        flat[4::17] = -4 * scale
    x = torch.from_numpy(xn).to(device, in_dtype)
    w8 = torch.from_numpy(rng.integers(-127, 128, (cout, cin, ks, ks)).astype(
        np.int8)).to(device)
    out_mul = torch.from_numpy(rng.uniform(1e-5, 1e-3, cout).astype(
        np.float32)).to(device)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(
        np.float32)).to(device)
    inv = torch.tensor(127.0 / scale, dtype=torch.float32, device=device)
    return x, w8, out_mul, bias, inv


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", INT8_DTYPES)
@pytest.mark.parametrize("case", INT8_CASES + INT8_ALL_SHAPES)
def test_int8_conv_equals_plain_version(cuda_device, case, dtypes):
    """Bit for bit: the int32 sums are exact (in any order and split of K)
    and the epilogue is a separate fp32 multiply and add in both."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic

    stride, pad = case[6], case[7]
    in_dtype, out_dtype = dtypes
    x, w8, out_mul, bias, inv = _int8_inputs(cuda_device, case, in_dtype,
                                             case[1] + case[4])
    before = ic.LAUNCHES
    got = ic.int8_conv(x, w8, ic.pack_weights(w8), out_mul, bias, inv,
                       stride, pad, True, out_dtype)
    want = ic.int8_conv_reference(x, w8, out_mul, bias, inv, stride, pad,
                                  True, out_dtype)
    torch.cuda.synchronize()
    assert ic.LAUNCHES == before + 1
    assert got.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("case", [
    (2, 256, 16, 32, 256, 3, 1, 1),    # NHWC, K split
    (2, 3, 64, 128, 32, 3, 2, 1),      # im2col (the stem)
    (1, 40, 9, 13, 19, 3, 1, 1),       # padded channels, ragged everything
])
def test_int8_conv_nonfinite_inputs_equal_plain_version(cuda_device, case,
                                                        relu):
    """NaN quantizes to 0 and +-inf, like values past the scale, to
    +-127, in the prologue as in the plain version: bit for bit, with and
    without ReLU."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic

    for in_dtype in (torch.float32, torch.bfloat16):
        x, w8, out_mul, bias, inv = _int8_inputs(cuda_device, case, in_dtype,
                                                 7, nonfinite=True)
        assert torch.isnan(x).any() and torch.isinf(x).any()
        args = (out_mul, bias, inv, case[6], case[7], relu, torch.bfloat16)
        got = ic.int8_conv(x, w8, ic.pack_weights(w8), *args)
        want = ic.int8_conv_reference(x, w8, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (8, 256, 64, 128, 256, 3, 1, 1),   # conv_out.conv
    (8, 1024, 16, 32, 128, 3, 1, 1),   # cp.arm32.conv: K split 8 ways
    (8, 3, 512, 1024, 32, 3, 2, 1),    # the stem: im2col
])
def test_int8_conv_graph_replay_equals_eager(cuda_device, case):
    """``int8_conv`` captured in a CUDA graph (its scratch from the graph's
    pool, its split-K counters zeroed by its own prologue on every replay)
    replays bit-identical to eager calls, also after the input buffer is
    overwritten; each call launches one prologue and one GEMM kernel, by
    the profiler's names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic

    stride, pad = case[6], case[7]
    x, w8, out_mul, bias, inv = _int8_inputs(cuda_device, case,
                                             torch.bfloat16, 3)
    packed = ic.pack_weights(w8)
    args = (w8, packed, out_mul, bias, inv, stride, pad, True,
            torch.bfloat16)
    ic.int8_conv(x, *args)                 # builds, caches the occupancy
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ic.int8_conv(x, *args)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    prologue = "im2col" if case[1] < ic.PIECE else "quantize"
    assert sum(f"int8_conv_{prologue}_kernel" in k for k in names) == 1, names
    assert sum("int8_conv_gemm_kernel" in k for k in names) == 1, names
    static_x = x.clone()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        ic.int8_conv(static_x, *args)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ic.LAUNCHES
    with torch.cuda.graph(graph):
        static_out = ic.int8_conv(static_x, *args)
    assert ic.LAUNCHES == before + 1
    for seed in (3, 4, 5):
        fresh = _int8_inputs(cuda_device, case, torch.bfloat16, seed)[0]
        static_x.copy_(fresh)
        graph.replay()
        want = ic.int8_conv(fresh, *args)
        torch.cuda.synchronize()
        assert torch.equal(static_out, want), seed
    assert torch.equal(want, ic.int8_conv_reference(fresh, w8, *args[2:]))


def _serving_models(device, h=64, w=128):
    """The seeded bf16 model and its int8 ``all`` model, and uint8 frames
    (pinned) of 3 at ``h`` x ``w``."""
    from dasemanticsegmentationaml_tpu_torch.ops.quantize import (
        PRESET_FILTERS, quantize_model)

    model = _seeded_eval_model(device)
    batches = _device_batches(device, 2, h=h, w=w)
    qmodel, _ = quantize_model(model, [x for x, _ in batches[:2]],
                               filter_fn=PRESET_FILTERS["all"],
                               amp_dtype=torch.bfloat16)
    frames, _ = _pinned_batch(7, n=3, h=h, w=w)
    return {"bf16": model, "int8 all": qmodel}, frames


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bf16", "int8 all"])
def test_artifact_equals_predict(cuda_device, tmp_path, name):
    """The loaded symbolic-batch artifact against ``predict`` on the same
    prepared batch, at batch 1 and 3, bit for bit; its saved graph holds
    the ops; a bundle's programs likewise at their batches."""
    from dasemanticsegmentationaml_tpu_torch.data.pipeline import (
        prepare_batch)
    from dasemanticsegmentationaml_tpu_torch.train.evaluate import predict
    from dasemanticsegmentationaml_tpu_torch.utils import export as ex

    models, frames = _serving_models(cuda_device)
    model = models[name]
    path, bundle = str(tmp_path / "m.pt2"), str(tmp_path / "b.zip")
    ex.export_inference(model, 64, 128, amp_dtype=torch.bfloat16, path=path)
    ex.export_inference_bundle(model, 64, 128, [1, 3],
                               amp_dtype=torch.bfloat16, path=bundle)
    meta = ex.read_meta(path)
    assert meta["device"] == "cuda" and meta["dtype"] == "bfloat16"
    assert meta["ops"] == (["upsample_argmax"] if name == "bf16"
                           else ["int8_conv", "upsample_argmax"])
    module = ex.load_exported(path)
    programs = ex.read_exported_bundle(bundle)
    with torch.inference_mode():
        for b in (1, 3):
            x, _ = prepare_batch(frames[:b], torch.zeros((b, 64, 128),
                                                         dtype=torch.uint8),
                                 device=cuda_device, dtype=torch.bfloat16)
            want = predict(model, x, True, torch.bfloat16)
            u8 = frames[:b].to(cuda_device)
            assert torch.equal(module(u8), want)
            assert torch.equal(programs[b].program.module()(u8), want)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bf16", "int8 all"])
def test_artifact_graph_replay_equals_eager(cuda_device, tmp_path, name):
    """``serve.Program`` replays one CUDA graph per batch size (1, 3) equal
    to the eager call of the loaded program, bit for bit, and again after
    the input changed."""
    from dasemanticsegmentationaml_tpu_torch import serve
    from dasemanticsegmentationaml_tpu_torch.utils import export as ex

    models, frames = _serving_models(cuda_device)
    path = str(tmp_path / "m.pt2")
    ex.export_inference(models[name], 64, 128, amp_dtype=torch.bfloat16,
                        path=path)
    module = ex.load_exported(path)
    runner = serve.Program(module, cuda_device)
    with torch.inference_mode():
        for frames_now in (frames, frames.flip(0).contiguous()):
            for b in (1, 3):
                got = runner(frames_now[:b])
                want = module(frames_now[:b].to(cuda_device)).cpu()
                assert torch.equal(got, want)
    assert sorted(runner.graphs) == [1, 3]


@pytest.mark.cuda
@pytest.mark.parametrize("name,blocks", [("bf16", 0), ("int8 all", 35)])
def test_artifact_launch_counts(cuda_device, tmp_path, name, blocks):
    """Through a loaded artifact each batch launches upsample_argmax once
    and the int8 kernels once a quantized block: eagerly by the wrappers'
    counters, and by ``serve.Program``'s replay count."""
    from dasemanticsegmentationaml_tpu_torch import serve
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic
    from dasemanticsegmentationaml_tpu_torch.utils import export as ex

    models, frames = _serving_models(cuda_device)
    path = str(tmp_path / "m.pt2")
    ex.export_inference(models[name], 64, 128, amp_dtype=torch.bfloat16,
                        path=path)
    module = ex.load_exported(path)
    u8 = frames.to(cuda_device)
    before = (ua.LAUNCHES, ic.LAUNCHES)
    with torch.inference_mode():
        for _ in range(2):
            module(u8)
    assert (ua.LAUNCHES - before[0], ic.LAUNCHES - before[1]) == (
        2, 2 * blocks)
    runner = serve.Program(module, cuda_device)
    runner(frames)
    replayed = dict(runner.replayed)
    runner(frames)
    assert runner.captured == {"upsample_argmax": 1, "int8_conv": blocks}
    assert {k: runner.replayed[k] - replayed[k] for k in replayed} == {
        "upsample_argmax": 1, "int8_conv": blocks}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_equal_plain_versions(cuda_device, dtype):
    """``dseg::upsample_argmax`` and ``dseg::int8_conv`` called as ops on
    the card equal their plain versions bit for bit, and count their
    launches."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic

    x = _logits(cuda_device, (3, 19, 16, 32), 5, "normal", dtype)
    n = ua.LAUNCHES
    got = torch.ops.dseg.upsample_argmax(x, 64, 128)
    assert ua.LAUNCHES == n + 1
    assert torch.equal(got, ua.upsample_argmax_reference(x, (64, 128)))
    g = torch.Generator().manual_seed(3)
    a = torch.randn((3, 32, 16, 24), generator=g).to(cuda_device, dtype)
    w8 = torch.randint(-127, 128, (48, 32, 3, 3), generator=g,
                       dtype=torch.int8).to(cuda_device)
    out_mul = (torch.rand(48, generator=g) * 1e-3).to(cuda_device)
    bias = torch.randn(48, generator=g).to(cuda_device)
    inv = torch.tensor(40.0, device=cuda_device)
    n = ic.LAUNCHES
    got = torch.ops.dseg.int8_conv(a, w8, ic.pack_weights(w8), out_mul, bias,
                                   inv, 1, 1, True, dtype)
    torch.cuda.synchronize()
    assert ic.LAUNCHES == n + 1
    assert torch.equal(got, ic.int8_conv_reference(a, w8, out_mul, bias, inv,
                                                   1, 1, True, dtype))


# ------------------------------------------- data parallelism on the card

def _parallel_batch():
    """A global batch of 2 x (2 x 3 x 1024 x 512), the shape the card-row
    bounds of PERF.md §2 were set at (at 256 x 128 the world-1 NCCL step
    and the plain one part by 0.0217 of the update: cuDNN's BN and the
    port's E[x^2] - E[x]^2 round apart, more with fewer values a
    channel): rank 1's labels 40% ignore, rank 0's 5%."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 3, 1024, 512)).astype(np.float32)
    frac = np.array([0.05, 0.05, 0.4, 0.4])[:, None, None]
    y = np.where(rng.random((4, 1024, 512)) < frac, 255,
                 rng.integers(0, 19, (4, 1024, 512))).astype(np.int32)
    return x, y


def _seeded_state(path):
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        build_bisenet)

    model = build_bisenet(19, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), path)
    return {k: v.double().numpy() for k, v in model.state_dict().items()}


def _update_l2(ours, ref, init):
    """||ours - ref|| / ||ref - init|| over the parameters and the same over
    the running statistics (update-relative, PERF.md §2)."""
    sq = {"param": [0.0, 0.0], "stat": [0.0, 0.0]}
    for key, want in ref.items():
        if key.endswith("num_batches_tracked"):
            continue
        kind = "stat" if key.endswith(("running_mean", "running_var")) \
            else "param"
        sq[kind][0] += float(np.sum((ours[key] - want) ** 2))
        sq[kind][1] += float(np.sum((want - init[key]) ** 2))
    return {k: float(np.sqrt(a / max(b, 1e-30))) for k, (a, b) in sq.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("sync_bn", [True, False])
def test_two_gloo_ranks_on_one_card_equal_one_process(cuda_device, tmp_path,
                                                      sync_bn):
    """Two gloo ranks share cuda:0 (NCCL refuses two ranks on one card):
    one fp32 sharded step (TF32 off) against one process on the card, the
    plain step on the global batch (sync) or the per-replica reference
    (a model copy a half, gradients averaged): loss rtol 1e-4, parameters
    and running statistics within global l2 0.02 of the update, the
    ranks' parameters equal."""
    import torch_ranks

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.train.optim import (
        make_optimizer)
    from dasemanticsegmentationaml_tpu_torch.train.supervised import (
        make_train_step)

    x, y = _parallel_batch()
    path = str(tmp_path / "g.pt")
    init = _seeded_state(path)
    ranks = torch_ranks.run_ranks(torch_ranks.card_train_step, tmp_path,
                                  state_path=path, x=x, y=y,
                                  sync_bn=sync_bn)
    with fp32_math():
        if sync_bn:
            model = torch_ranks._bisenet(path).to(cuda_device)
            opt = make_optimizer("sgd", trainable_parameters(model), 0.01,
                                 momentum=0.9, weight_decay=1e-4)
            loss = float(make_train_step(model, opt)(
                torch.from_numpy(x).to(cuda_device),
                torch.from_numpy(y).to(cuda_device)))
            ref = torch_ranks._snapshot(0, model)[0]
        else:
            loss, ref, _ = torch_ranks.per_replica_reference(
                path, x, y, 0.01, 1e-4, device=cuda_device)
    assert ranks[0][0] == ranks[1][0]
    np.testing.assert_allclose(ranks[0][0], loss, rtol=1e-4)
    for key, value in ranks[1][1].items():
        if isinstance(value, float):
            assert value == float(ranks[0][1][key].sum()), key
    l2 = _update_l2(ranks[0][1], ref, init)
    assert l2["param"] < 0.02 and l2["stat"] < 0.02, l2


@pytest.mark.cuda
def test_nccl_world_1_sync_step_equals_the_step_without_a_group(
        cuda_device, tmp_path):
    """One sync-BN step through a real NCCL communicator at world 1
    against the plain step (fp32, TF32 off): loss rtol 1e-4, global l2
    0.02 of the update; allreduce_counts through it returns its input."""
    import torch_ranks

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.train.optim import (
        make_optimizer)
    from dasemanticsegmentationaml_tpu_torch.train.supervised import (
        make_train_step)

    x, y = _parallel_batch()
    path = str(tmp_path / "g.pt")
    init = _seeded_state(path)
    ((loss, state, counts_ok),) = torch_ranks.run_ranks(
        torch_ranks.card_train_step, tmp_path, world=1, backend="nccl",
        state_path=path, x=x[:2], y=y[:2], sync_bn=True, counts=True)
    model = torch_ranks._bisenet(path).to(cuda_device)
    opt = make_optimizer("sgd", trainable_parameters(model), 0.01,
                         momentum=0.9, weight_decay=1e-4)
    with fp32_math():
        plain_loss = float(make_train_step(model, opt)(
            torch.from_numpy(x[:2]).to(cuda_device),
            torch.from_numpy(y[:2]).to(cuda_device)))
    assert counts_ok
    np.testing.assert_allclose(loss, plain_loss, rtol=1e-4)
    l2 = _update_l2(state, torch_ranks._snapshot(0, model)[0], init)
    assert l2["param"] < 0.02 and l2["stat"] < 0.02, l2


# ----------------------------------------------- the row-window kernels

def _row_windows(h, out_h, parts):
    """(RowWindow, the logits rows [lo, hi)) of each even band of
    ``out_h`` output rows, and of single rows at both ends."""
    from dasemanticsegmentationaml_tpu_torch.ops.resize import (
        RowWindow, window_rows)

    bands = [(s * out_h // parts, (s + 1) * out_h // parts)
             for s in range(parts)] + [(0, 1), (out_h - 1, out_h)]
    out = []
    for y0, y1 in bands:
        lo, hi = window_rows(y0, y1, h, out_h)
        out.append((RowWindow(y0, y1, h, out_h, lo), hi))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["normal", "ties", "nonfinite"])
@pytest.mark.parametrize("shape,out_hw,parts", [
    ((2, 19, 64, 128), (512, 1024), 2),   # the spatial eval's bands
    ((2, 19, 64, 128), (512, 1024), 4),
    ((1, 19, 13, 16), (100, 120), 4),      # taps past both band edges
    ((2, 3, 16, 32), (128, 256), 3),       # the generic instance
])
def test_windowed_upsample_argmax_equals_full_rows(cuda_device, shape,
                                                   out_hw, parts, kind,
                                                   dtype):
    """Each window's launch equals the same rows of the full kernel's and
    the windowed plain version, bit for bit; one launch a window."""
    x = _logits(cuda_device, shape, 3, kind, dtype)
    full = ua.upsample_argmax(x, out_hw)
    for window, hi in _row_windows(shape[2], out_hw[0], parts):
        band = x[:, :, window.base:hi].contiguous()
        rows = (window.y1 - window.y0, out_hw[1])
        before = ua.LAUNCHES
        got = ua.upsample_argmax(band, rows, window=window)
        torch.cuda.synchronize()
        assert ua.LAUNCHES == before + 1
        assert torch.equal(got, full[:, window.y0:window.y1]), window
        assert torch.equal(got, ua.upsample_argmax_reference(band, rows,
                                                             window))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,out_hw,parts", [
    ((2, 19, 64, 32), (512, 256), 2),
    ((1, 19, 13, 16), (100, 120), 4),
    ((2, 3, 16, 32), (128, 256), 3),
])
def test_windowed_fused_ce_equals_plain_and_full(cuda_device, shape,
                                                 out_hw, parts, dtype):
    """Each band's kernels against the windowed plain version (loss 1e-5
    of |loss|, gradient 1e-4 of its max plus a bf16 ulp); the bands'
    shares over the global count sum to the full kernel's loss within
    1e-5; in fp32 their gradients, put into the logits, equal the full
    kernel's within 1e-4 of its max (in bf16 a halo row's two rounded
    parts need not round to the whole's)."""
    x = _logits(cuda_device, shape, 0, "normal", dtype)
    labels = _ce_labels(cuda_device, (shape[0], *out_hw), 1, False,
                        shape[1])
    full, full_grad = _ce_value_and_grad(fc.cross_entropy_upsampled, x,
                                         labels, out_hw)
    n_valid = ((labels >= 0) & (labels < shape[1])).sum().float()
    total = 0.0
    assembled = torch.zeros_like(x, dtype=torch.float32)
    for window, hi in _row_windows(shape[2], out_hw[0], parts)[:parts]:
        band = x[:, :, window.base:hi].contiguous()
        lab = labels[:, window.y0:window.y1].contiguous()
        rows = (window.y1 - window.y0, out_hw[1])
        kw = dict(window=window, n_valid=n_valid)
        loss, grad = _ce_value_and_grad(
            lambda v, t, o: fc.cross_entropy_upsampled(v, t, o, **kw), band,
            lab, rows)
        want, want_grad = _ce_value_and_grad(
            lambda v, t, o: fc.cross_entropy_upsampled_reference(v, t, o,
                                                                 **kw),
            band, lab, rows)
        assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
        bound = 1e-4 * want_grad.float().abs().max()
        if dtype == torch.bfloat16:
            bound = bound + 2.0**-7 * want_grad.float().abs()
        assert bool(((grad.float() - want_grad.float()).abs()
                     <= bound).all())
        total += loss.item()
        assembled[:, :, window.base:hi] += grad.float()
    assert abs(total - full.item()) <= 1e-5 * abs(full.item())
    if dtype == torch.float32:
        bound = 1e-4 * full_grad.abs().max()
        assert bool(((assembled - full_grad).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,out_hw,parts", [
    ((2, 19, 64, 128), (512, 1024), 2),
    ((1, 19, 13, 16), (100, 120), 4),
])
def test_windowed_upsample_argmax_op_equals_the_launch(cuda_device, shape,
                                                       out_hw, parts, dtype):
    """The op a height-sharded artifact holds, ``dseg::upsample_argmax_
    window``, on a card: the wrapper's windowed launch, bit for bit, one
    launch counted in both counters."""
    x = _logits(cuda_device, shape, 4, "normal", dtype)
    for window, hi in _row_windows(shape[2], out_hw[0], parts):
        band = x[:, :, window.base:hi].contiguous()
        rows = (window.y1 - window.y0, out_hw[1])
        before = (ua.LAUNCHES, ua.WINDOW_LAUNCHES)
        got = torch.ops.dseg.upsample_argmax_window(
            band, window.h, window.H, out_hw[1], window.base, window.y0,
            window.y1)
        torch.cuda.synchronize()
        assert (ua.LAUNCHES, ua.WINDOW_LAUNCHES) == (before[0] + 1,
                                                     before[1] + 1)
        assert torch.equal(got, ua.upsample_argmax(band, rows,
                                                   window=window)), window


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", INT8_DTYPES[:2])
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("case", [c for c in INT8_CASES if c[5] == 3]
                         + [INT8_ALL_SHAPES[0], INT8_ALL_SHAPES[-1]])
def test_int8_conv_band_equals_plain_and_whole_rows(cuda_device, case, parts,
                                                    dtypes):
    """A band of output rows of the height-sharded mesh: its window (the
    rows it reads, zeros outside the image) with ``pad_h = 0``, bit for bit
    against the plain version on the window and the whole kernel's rows."""
    import torch.nn.functional as F

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic

    _, _, _, _, _, ks, s, p = case
    in_dtype, out_dtype = dtypes
    x, w8, out_mul, bias, inv = _int8_inputs(cuda_device, case, in_dtype,
                                             case[1] + parts)
    args = (w8, ic.pack_weights(w8), out_mul, bias, inv, s)
    whole = ic.int8_conv(x, *args, p, True, out_dtype)
    padded = F.pad(x, (0, 0, p, p))
    n_out = whole.shape[2]
    for k in range(parts):
        o0, o1 = k * n_out // parts, (k + 1) * n_out // parts
        win = padded[:, :, o0 * s:(o1 - 1) * s + ks].contiguous()
        got = ic.int8_conv(win, *args, (0, p), True, out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, ic.int8_conv_reference(
            win, w8, out_mul, bias, inv, s, (0, p), True, out_dtype))
        assert torch.equal(got, whole[:, :, o0:o1]), (o0, o1)


def _write_gtav(root, n, size=(64, 128), seed=1):
    """tests/test_torch_eval.py::_mk_gtav's layout: palettised raw GTA5
    ids."""
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)
    for top in ("images", "labels"):
        os.makedirs(os.path.join(root, top), exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)
                        ).save(os.path.join(root, "images", f"{i:05d}.png"))
        lab = Image.fromarray(rng.integers(0, 35, size, dtype=np.uint8),
                              mode="P")
        lab.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tolist())
        lab.save(os.path.join(root, "labels", f"{i:05d}.png"))


@pytest.mark.cuda
def test_port_hpo_trial_on_card(cuda_device, tmp_path):
    """One HPO trial in-process on cuda:0 (128x256, bf16, batch 2, 3 epochs
    of 1 step): 2 fused CE launches a DA step, forward and backward, the
    eval kernel in every validation, one intermediate record a validation
    and the final one their max."""
    import json
    import math

    from dasemanticsegmentationaml_tpu_torch.hpo import trial

    size = (128, 256)
    cs, gta = str(tmp_path / "cs"), str(tmp_path / "gta")
    _write_cityscapes(cs, "train", 4, size=size)
    _write_cityscapes(cs, "val", 2, size=size, seed=1)
    _write_gtav(gta, 4, size=size)
    out = str(tmp_path / "trial.jsonl")
    epochs = 3
    params = {"batch_size": 2, "num_epochs": epochs, "lr": 1e-3}
    fc.FWD_LAUNCHES = fc.BWD_LAUNCHES = ua.LAUNCHES = 0
    miou = trial.main([
        "--nni_params", json.dumps(params), "--nni_output", out,
        "--root", cs, "--root_source", gta, "--root_target", cs,
        "--crop_height", str(size[0]), "--crop_width", str(size[1]),
        "--faithful_resize", "False", "--eval_batch_size", "2",
        "--validation_step", "1", "--checkpoint_step", "50",
        "--max_steps_per_epoch", "1", "--num_workers", "1",
        "--dtype", "bfloat16", "--tensorboard", "False", "--cuda", "0",
        "--save_model_path", str(tmp_path / "run")])
    launches = (fc.FWD_LAUNCHES, fc.BWD_LAUNCHES, ua.LAUNCHES)
    assert launches[:2] == (2 * epochs, 2 * epochs), launches
    assert launches[2] > 0
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    assert [r["type"] for r in recs] == ["intermediate"] * 2 + ["final"]
    assert all(math.isfinite(r["value"]) for r in recs)
    assert recs[-1]["value"] == max(r["value"] for r in recs[:-1]) == miou
