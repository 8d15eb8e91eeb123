#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, phase by phase.

    python3 chip_smoke.py
    python3 chip_smoke.py --baseline DIR

With ``--baseline``, after the device and build phases, the
upsample+argmax, fused CE and fused CatBottleneck kernels of the port's
version under DIR (an earlier commit's
``dasemanticsegmentationaml_tpu_torch/``, unpacked with ``git archive``
into a git-ignored directory) are held against this checkout's: the
earlier upsample+argmax on the kernel phase's cases (its disagreements
logged), then each kernel and the eval forward, train step or
features[2:8] chain with it timed in turns A B B A; nothing else runs
(``compare_baseline``).

1. device      -- a CUDA card must be present (exit 1 otherwise, no CPU
                  fallback); prints its name and power limit from nvidia-smi.
2. build       -- compiles csrc/upsample_argmax.cu, csrc/fused_ce.cu,
                  csrc/fused_stdc.cu, csrc/copy_probe.cu and csrc/tile_roll.cu
                  with nvcc for sm_90a, one nvcc each, all at once; prints
                  ptxas.
3. kernel      -- the fused upsample+argmax kernel against its plain PyTorch
                  version on the card, bit for bit, on random-normal,
                  tie-heavy and non-finite (NaN, +-inf, an all-NaN pixel)
                  logits in fp32 and bf16, at the main path's shapes (B = 1
                  and 2) and at edge shapes (odd sizes, identity, h = 1, one
                  source or output pixel, downsampling, w = 1, C = 3, 32
                  and 40, a ragged last band).
4. ce-kernel   -- the fused upsample+CE forward and backward kernels against
                  their plain version (loss, gradient) in fp32 and bf16, at
                  the train step's three head shapes and at edge shapes
                  (odd sizes, identity, downsampling, h = 1 and 2, w = 1,
                  B = 1 at 1024x512, C = 3 and 32, band edges between
                  output rows), with ignored, out-of-range and all-ignored
                  labels; two runs bit-identical.
5. stdc-kernel -- the fused CatBottleneck kernels (fused_cat_s1 / _s2)
                  against their plain PyTorch version on folded weights, at
                  the six STDC813 bottleneck shapes at batch 8, 1024x512 and
                  at edge shapes, in fp32 and bf16; two runs bit-identical.
6. copy-probe  -- every variant of the probe's sweep of the three copy
                  kernels (copy_block, copy_direct, and the TMA ring
                  copy_bounce at 2 and 8 slots over every split between
                  loads ahead and stores unread) against x.clone(), bit for
                  bit, at 16384x8192 bf16 and at edge sizes; then their
                  path, the probe_copy entry point at 16384x8192 bf16 (the
                  counts reset before and read after), and copy_ and x + 0
                  (the library yardsticks) and x.clone() by the probe's own
                  protocol, with GB/s and the share of 3.35 TB/s; then each
                  kernel at its defaults against copy_ in turns A B B A, by
                  the probe's protocol and as CUDA-graph replays of the same
                  chain (device only), with the verdict "slower than copy_"
                  or not.
7. roll-kernel -- tile_roll against its plain version (slices + cat) and
                  torch.roll, bit for bit, in fp32, int32, bf16 and int16
                  at (8, 128) and at edge shapes and shifts; then its
                  path, the roll_repro entry
                  point (the count reset before and read after); then the
                  kernel, its plain version and torch.roll at 16384x8192 bf16
                  in turns A B B A.
8. stdc-path   -- the fused bottleneck's own path (not wired into any CLI,
                  as in the JAX package): a seeded STDCNet813 in eval mode,
                  its features[2:8] folded and run as six fused launches in
                  bf16 at batch 8, 1024x512 (the counts reset before and read
                  after), against the eager modules in fp32.
9. model       -- full-width BiSeNet-STDC813 (seeded weights) at 2x3x512x1024:
                  fp32 features on the card against the same module on the CPU
                  (TF32 off), and bf16 autocast predictions against fp32.
10. slice      -- the port's --domain_shift CLI on a synthetic 4-image
                  Cityscapes val tree at 1024x512 on cuda:0 in bf16 (the
                  kernel's launch count is reset before and read after), then
                  fp32 on the card against fp32 on the CPU.
11. train      -- the port's supervised CLI on a synthetic 16 + 4 image tree
                  at 1024x512, batch 8, bf16, 2 epochs of 2 steps (the
                  kernels' counts reset before and read after); its best.pth
                  through the --domain_shift CLI reproduces its mIoU.
12. train-parity- one fp32 train step at 2x3x1024x512 on the card against
                  the same step on the CPU (TF32 off) and in fp64 on the CPU.
13. da        -- the port's DA CLI (GTA5 -> Cityscapes) on synthetic 16 +
                  16 + 4 image trees at 1024x512, batch 8, bf16, 2 epochs of
                  2 steps, once with the FC discriminator and the 4-phase
                  step, once with the DW+BN one and the combined step (the CE
                  kernels' counts reset before and read after each); its
                  GTA5_1.pth through the --domain_shift CLI.
14. da-parity  -- one fp32 DA step (DW+BN discriminator) at 2x3x1024x512 on
                  the card against the same step on the CPU (TF32 off) and in
                  fp64 on the CPU.
15. timing     -- CUDA-event times of every kernel and of its plain version
                  (the upsample+argmax, CE and CatBottleneck kernels and
                  their plain version also by their device time alone,
                  from the profiler's kernel sums; upsample+argmax beside
                  its bound and its issue floor; each CatBottleneck beside
                  the eager cuDNN module, with the device time of each
                  phase of its launch and the GMAC its plan does),
                  features + argmax kernel throughput, the bf16 train step at
                  batch 8 with the CE kernel and with its plain version (turns
                  A B B A, peak memory), the bf16 DA step at batch 8, the
                  features[2:8] chain eager (cuDNN) against fused, and
                  torch.profiler passes: device busy share, top kernels and
                  the CE kernels' share of the train and DA steps.

Every failure raises and ends the run with a non-zero exit. The line
before the last is the kernels' JSON record: each kernel's launches on its
path, its largest difference from its plain version, its time, its plain
version's and, where one PyTorch call computes the same function, that
call's (``library_ms``), beside its bound (``bound_ms``: the larger of its
bytes over 3.35 TB/s and its operations over their peak rate, from this
run's shapes; ``bound_by`` says which). Every ``ms`` there is a chain of
calls timed by CUDA events, the host path included; the upsample+argmax,
CE and CatBottleneck kernels add their device time alone and their plain
version's (``device_ms``, ``plain_device_ms``), the CatBottleneck the
eager cuDNN modules' too (``eager_ms``, ``eager_device_ms``: no one
PyTorch call computes a CatBottleneck, so ``library_ms`` stays null). The last line is ``{"ok": true, "device": {...}}``.
"""

import copy
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "dasemanticsegmentationaml_tpu_torch/csrc/upsample_argmax.cu"
KERNEL_REPLACES = "dasemanticsegmentationaml_tpu/ops/pallas/upsample_argmax.py:252"
CE_SOURCE = "dasemanticsegmentationaml_tpu_torch/csrc/fused_ce.cu"
CE_REPLACES = "dasemanticsegmentationaml_tpu/ops/pallas/fused_ce.py:303"
STDC_SOURCE = "dasemanticsegmentationaml_tpu_torch/csrc/fused_stdc.cu"
STDC_REPLACES = {1: "dasemanticsegmentationaml_tpu/ops/pallas/fused_stdc.py:326",
                 2: "dasemanticsegmentationaml_tpu/ops/pallas/fused_stdc.py:376"}
COPY_SOURCE = "dasemanticsegmentationaml_tpu_torch/csrc/copy_probe.cu"
COPY_REPLACES = {"copy_block": "tools/probe_pallas_dma.py:34",
                 "copy_direct": "tools/probe_dma_manual.py:132",
                 "copy_bounce": "tools/probe_dma_manual.py:132"}
ROLL_SOURCE = "dasemanticsegmentationaml_tpu_torch/csrc/tile_roll.cu"
ROLL_REPLACES = "tools/mosaic_roll_repro.py:30"
#: the ring depth whose time stands for copy_bounce in the kernels' record
BOUNCE_SLOTS = 8
#: the CE kernels' names in a profile: the forward's band and finishing
#: kernels, the backward's band and edge kernels (an earlier version's
#: ce_*_rows ones too)
CE_KERNELS = {"fwd": ("ce_fwd",), "bwd": ("ce_bwd",)}
#: the upsample+argmax shapes timed: the CLI's eval batch of 1, batch 8
#: (512x1024 input) and the kernels' JSON line's shape (the CLI's
#: faithful-resize shape)
ARGMAX_TIMED = (((1, 19, 64, 128), (512, 1024)),
                ((8, 19, 64, 128), (512, 1024)),
                ((2, 19, 128, 64), (1024, 512)))
#: the upsample+argmax kernel's name in a profile (an earlier version's too)
ARGMAX_KERNELS = ("upsample_argmax",)
#: the fused CatBottleneck's kernels in a profile (an earlier version's too)
STDC_KERNELS = ("fused_cat",)
#: the module name under which --baseline imports another version
BASELINE = "baseline_torch_port"
#: an H100 SXM (NVIDIA's data sheet, dense): operations/s by type, fp32
#: outside the tensor cores, bf16 on them (its device-memory rate is
#: tools/probe_copy.py::PEAK_BYTES_PER_S)
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16_tensor": 989e12}
#: the six STDC813 bottlenecks, features[2:8], at batch 8 and 1024x512
#: (models/stdcnet.py:174-190): stride, input (C, H, W), (h1, h2, h3, h4)
STDC813_BOTTLENECKS = (
    (2, (64, 128, 256), (128, 64, 32, 32)),
    (1, (256, 64, 128), (128, 64, 32, 32)),
    (2, (256, 64, 128), (256, 128, 64, 64)),
    (1, (512, 32, 64), (256, 128, 64, 64)),
    (2, (512, 32, 64), (512, 256, 128, 128)),
    (1, (1024, 16, 32), (512, 256, 128, 128)),
)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters, warmup=3):
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, match=None, n=20, tries=3):
    """Device milliseconds per call of ``fn`` spent in the kernels whose
    name contains one of ``match`` (every kernel when None), by
    torch.profiler's kernel sums over ``n`` calls (the host path excluded);
    and those milliseconds by kernel name. A profile now and then records
    no kernel of the card at all: it is taken again, up to ``tries`` times,
    before this raises."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        hits = [e for e in kernels
                if match is None or any(m in e.key for m in match)]
        if hits:
            break
        seen.append(f"{len(kernels)} kernels")
    else:
        raise RuntimeError(f"the profiler saw no kernel named {match} in "
                           f"{tries} tries (it saw {', '.join(seen)})")
    by_name = {}
    for e in hits:
        name = e.key[:60] if match is None else next(
            w for w in re.findall(r"\w+", e.key) if any(m in w for m in match))
        by_name[name] = (by_name.get(name, 0.0)
                         + e.self_device_time_total / 1e3 / n)
    return sum(by_name.values()), by_name


def ce_calls(fn, x, labels, out_hw):
    """(forward, backward) of the CE function ``fn``: one forward without
    autograd, and one backward through a graph kept for reuse."""
    import torch

    def fwd():
        with torch.no_grad():
            fn(x, labels, out_hw)

    loss = fn(x, labels, out_hw)

    def bwd():
        torch.autograd.grad(loss, x, retain_graph=True)

    return fwd, bwd


def load_baseline(root, module):
    """``ops/cuda/<module>`` of another version of the port, the package
    ``dasemanticsegmentationaml_tpu_torch/`` under ``root`` (an earlier
    commit unpacked with ``git archive``), imported under its own name
    ``baseline_torch_port``: its imports are relative, so its modules,
    counters and caches stay its own, and its kernels build from its own
    ``csrc/`` into its own ``build/``."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(root),
                       "dasemanticsegmentationaml_tpu_torch")
    init = os.path.join(pkg, "__init__.py")
    if not os.path.isfile(init):
        raise FileNotFoundError(f"no package at {pkg}")
    if BASELINE not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            BASELINE, init, submodule_search_locations=[pkg])
        module_ = importlib.util.module_from_spec(spec)
        sys.modules[BASELINE] = module_
        spec.loader.exec_module(module_)
    return importlib.import_module(f"{BASELINE}.ops.cuda.{module}")


def roofline(nbytes, ops):
    """(bound_ms, bound_by): the least time the card could take for work
    that moves ``nbytes`` (each input read once, each output written once)
    and does ``ops`` ({type: operations}, each at its peak rate): the
    larger of the two times."""
    from dasemanticsegmentationaml_tpu_torch.tools.probe_copy import (
        PEAK_BYTES_PER_S)

    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nonfinite(x):
    """NaN, +inf and -inf at set places, one source pixel all NaN and one
    all -inf (in place; ``x`` is (B, C, h, w) float32)."""
    b, c, h, w = x.shape
    x[0, min(3, c - 1), h // 2, w // 3] = np.nan
    x[-1, c // 2, 0, w - 1] = np.inf
    x[0, c - 1, h - 1, 0] = -np.inf
    x[-1, :, h - 1, w // 2] = np.nan
    x[0, :, 0, w // 2] = -np.inf
    return x


def logits_on(device, shape, seed, kind, dtype):
    """Random-normal logits; "ties": small integers, so exact ties between
    classes are common; "nonfinite": with NaN and infs at set places."""
    import torch

    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 4).astype(np.float32)
    elif kind == "nonfinite":
        x = nonfinite(x)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


#: (logits shape, output size) of the upsample+argmax cases: the main
#: path's shapes, then the shapes a column-segment plan can get wrong
KERNEL_CASES = (
    ((2, 19, 64, 128), (512, 1024)),   # 512x1024 input
    ((2, 19, 128, 64), (1024, 512)),   # the CLI's faithful-resize shape
    ((1, 19, 64, 128), (512, 1024)),   # B = 1, the CLI's eval batch
    ((1, 19, 7, 13), (37, 50)),        # odd sizes, no multiple of 8
    ((2, 19, 64, 128), (64, 128)),     # identity
    ((1, 19, 1, 13), (37, 50)),        # h = 1
    ((1, 19, 1, 1), (3, 5)),           # one source pixel
    ((3, 19, 5, 9), (1, 1)),           # one output pixel
    ((1, 19, 37, 50), (7, 13)),        # downsampling: empty segments
    ((1, 19, 5, 1), (9, 7)),           # w = 1: one segment a row
    ((2, 3, 16, 32), (128, 256)),      # C = 3, the generic instance
    ((2, 32, 16, 32), (128, 256)),     # C = 32, one generic chunk
    ((1, 40, 9, 11), (45, 61)),        # C = 40, two chunks
    ((2, 19, 13, 16), (100, 120)),     # ragged last band
    ((1, 19, 3, 1000), (5, 1100)),     # w > 256: one row a band
    ((1, 19, 2, 8), (2, 12500)),       # rows too wide to stage: stored straight
)
KINDS = ("normal", "ties", "nonfinite")


def kernel_cases(device, ua):
    """``ua.upsample_argmax`` (the module of this checkout or of another
    version) against this checkout's plain version on every case of
    ``KERNEL_CASES`` x fp32, bf16 x ``KINDS``: (cases, the ones that
    differ with their share of differing pixels, launches counted, the
    largest |label - plain label|)."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax

    before = ua.LAUNCHES
    bad = []
    n, max_err = 0, 0
    for shape, out_hw in KERNEL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for kind in KINDS:
                x = logits_on(device, shape, n, kind, dtype)
                got = ua.upsample_argmax(x, out_hw)
                want = upsample_argmax.upsample_argmax_reference(x, out_hw)
                torch.cuda.synchronize()
                check(got.shape == (shape[0], *out_hw)
                      and got.dtype == torch.int32, f"bad output {got.shape}")
                max_err = max(max_err, (got - want).abs().max().item())
                if not torch.equal(got, want):
                    bad.append((shape, out_hw, str(dtype), kind,
                                (got != want).float().mean().item()))
                n += 1
    return n, bad, ua.LAUNCHES - before, max_err


def phase_kernel(device):
    """The upsample+argmax kernel bit for bit against its plain version
    (torch.argmax: the first NaN, otherwise the first of the largest) on
    every case; its counter rises by each call."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua

    n, bad, launches, max_err = kernel_cases(device, ua)
    check(not bad, f"kernel != plain on {len(bad)} of {n} cases: {bad}")
    check(launches == n, f"LAUNCHES rose by {launches}, expected {n}")
    log("kernel", f"{n} cases bit-identical to the plain version "
        f"(fp32+bf16, random-normal+tie-heavy+non-finite); max "
        f"|kernel-plain| = {max_err}; LAUNCHES +{n}")
    return max_err


def ce_labels(device, shape, seed, mode, num_classes=19):
    """int32 labels: 'mixed' = ~10% ignore (255) and ~5% in 19..254, the
    rest valid; 'ignored' = every pixel 255."""
    import torch

    rng = np.random.default_rng(seed)
    if mode == "ignored":
        y = np.full(shape, 255, np.int32)
    else:
        y = rng.integers(0, num_classes, shape)
        r = rng.random(shape)
        y = np.where(r < 0.10, 255, y)
        y = np.where((r >= 0.10) & (r < 0.15),
                     rng.integers(num_classes, 255, shape), y)
    return torch.from_numpy(y.astype(np.int32)).to(device)


def ce_value_and_grad(fn, x, labels, out_hw):
    import torch

    x = x.detach().requires_grad_()
    loss = fn(x, labels, out_hw)
    (grad,) = torch.autograd.grad(loss, x)
    return loss.detach(), grad


#: the three heads of one train step at batch 8, 1024 x 512 (out, out16,
#: out32 at strides 8, 8, 16)
CE_MAIN_CASES = (((8, 19, 128, 64), (1024, 512)),
                 ((8, 19, 128, 64), (1024, 512)),
                 ((8, 19, 64, 32), (1024, 512)))


def phase_ce_kernel(device):
    """The fused CE kernels against their plain version: loss within
    1e-5 of |loss|; gradients within 1e-4 of max|grad| (the sums run in
    another order), plus, for bf16 gradients, one bf16 ulp of each element
    (at most 2^-7 |grad|): the two fp32 sums may round to neighbouring
    bf16 values. Two runs bit-identical; the counters rise by the calls."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc

    cases = [(s, hw, "mixed") for s, hw in CE_MAIN_CASES] + [
        ((1, 19, 7, 13), (37, 50), "mixed"),     # odd sizes
        ((2, 19, 64, 128), (64, 128), "mixed"),  # identity
        ((1, 19, 1, 13), (37, 50), "mixed"),     # h = 1
        ((1, 19, 1, 1), (3, 5), "mixed"),        # one source pixel
        ((2, 19, 8, 16), (64, 128), "ignored"),  # all ignored
        ((1, 19, 37, 50), (7, 13), "mixed"),     # downsampling
        ((1, 19, 2, 16), (64, 128), "mixed"),    # h = 2, one band
        ((1, 19, 128, 64), (1024, 512), "mixed"),  # B = 1, few blocks
        ((2, 3, 16, 32), (128, 256), "mixed"),   # C = 3 (the generic path)
        ((2, 32, 16, 32), (128, 256), "mixed"),  # C = 32
        ((2, 19, 13, 16), (100, 120), "mixed"),  # band edges between rows
        ((1, 19, 5, 1), (9, 1), "mixed"),        # w = 1
    ]
    fwd0, bwd0 = fc.FWD_LAUNCHES, fc.BWD_LAUNCHES
    calls = 0
    errs = {"loss": 0.0, "grad": 0.0}
    for n, (shape, out_hw, mode) in enumerate(cases):
        labels = ce_labels(device, (shape[0], *out_hw), n, mode, shape[1])
        for dtype in (torch.float32, torch.bfloat16):
            x = logits_on(device, shape, n, "normal", dtype)
            loss, grad = ce_value_and_grad(fc.cross_entropy_upsampled, x,
                                           labels, out_hw)
            loss2, grad2 = ce_value_and_grad(fc.cross_entropy_upsampled, x,
                                             labels, out_hw)
            calls += 2
            want, want_grad = ce_value_and_grad(
                fc.cross_entropy_upsampled_reference, x, labels, out_hw)
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "")
            check(loss.dtype == torch.float32 and loss.shape == ()
                  and grad.dtype == dtype and grad.shape == x.shape,
                  f"bad outputs {loss.dtype} {grad.dtype} {grad.shape}")
            check(torch.equal(loss, loss2) and torch.equal(grad, grad2),
                  f"two runs differ at {shape}->{out_hw} {name}")
            d_loss = abs(loss.item() - want.item())
            diff = (grad.float() - want_grad.float()).abs()
            g_max = want_grad.float().abs().max().item()
            d_grad = diff.max().item()
            errs["loss"] = max(errs["loss"], d_loss)
            errs["grad"] = max(errs["grad"], d_grad)
            bound = 1e-4 * g_max
            if dtype == torch.bfloat16:
                over = diff > bound + 2.0**-7 * want_grad.float().abs()
            else:
                over = diff > bound
            log("ce-kernel", f"{shape}->{out_hw} {mode} {name}: loss "
                f"{loss.item():.7f} vs plain {want.item():.7f} (|d| "
                f"{d_loss:.3e}, bound {1e-5 * abs(want.item()):.3e}); "
                f"grad max|d| {d_grad:.3e} = {d_grad / max(g_max, 1e-30):.3e}"
                f" of max|grad| {g_max:.3e}; over the bound: "
                f"{int(over.sum().item())}; bit-identical rerun")
            if mode == "ignored":
                check(loss.item() == 0.0 and not grad.any().item(),
                      "all-ignored: loss and grad must be 0")
            check(d_loss <= 1e-5 * abs(want.item()), "loss off")
            check(not over.any().item(), "grad off")
    check(fc.FWD_LAUNCHES - fwd0 == calls and fc.BWD_LAUNCHES - bwd0 == calls,
          f"launch counters rose by {fc.FWD_LAUNCHES - fwd0}/"
          f"{fc.BWD_LAUNCHES - bwd0}, expected {calls}")
    log("ce-kernel", f"{len(cases)} cases x fp32+bf16 within bounds; max "
        f"|d loss| {errs['loss']:.3e}, max |d grad| {errs['grad']:.3e}; "
        f"FWD_LAUNCHES and BWD_LAUNCHES +{calls}")
    return errs


def seed_cat_block(block, seed):
    """Seeded weights and running statistics away from identity, so that
    the BN folding is exercised (fresh running stats fold to identity)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in block.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif name.endswith("weight") and t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=gen)
                        * (2.0 / t[0].numel()) ** 0.5)
            else:
                t.copy_(0.1 * torch.randn(t.shape, generator=gen)
                        + (1.0 if name.endswith("bn.weight") else 0.0))
    return block.eval()


def stdc_cases():
    """(name, stride, input (B, C, H, W), (h1, h2, h3, h4)): the six
    bottlenecks at batch 8, then edge shapes: odd H and W at stride 1 and
    2, H = 2 at stride 2, a width below one tile, maps that leave a ragged
    last tile of 64 or 128 pixels both ways (the stride-2 front's x1
    region always ends in a ragged 64 rows), and out_c = 32 and 64 at both
    strides, whose (16, 8, 4, 4) and (32, 16, 8, 8) channels lie below the
    MMA's 64 output and 16 input channels."""
    cases = [(f"features[{i + 2}]", s, (8, *chw), chans)
             for i, (s, chw, chans) in enumerate(STDC813_BOTTLENECKS)]
    b2, b3, b4, b5 = (STDC813_BOTTLENECKS[i][2] for i in range(4))
    cases += [("odd s1", 1, (2, 256, 19, 37), b3),
              ("odd s2", 2, (1, 256, 13, 7), b4),
              ("H=2 s2", 2, (1, 64, 2, 30), b2),
              ("W=3 s1", 1, (2, 512, 9, 3), b5),
              ("ragged s1", 1, (2, 512, 11, 21), b5),
              ("ragged s2", 2, (1, 256, 29, 45), b4),
              ("out_c 32 s1", 1, (2, 16, 12, 20), (16, 8, 4, 4)),
              ("out_c 32 s2", 2, (1, 16, 15, 9), (16, 8, 4, 4)),
              ("out_c 64 s1", 1, (1, 24, 7, 33), (32, 16, 8, 8)),
              ("out_c 64 s2", 2, (2, 40, 18, 10), (32, 16, 8, 8))]
    return cases


def stdc_plan_text(fs, x, fp):
    """What the wrapper plans for ``x`` and ``fp`` on this card, in a few
    words."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda.build import sm_count

    b, c, h, w = x.shape
    s = fp.stride
    if x.element_size() == 4:
        p = fs.plan(s, 4, c, fp.channels, b, (-(-h // s), -(-w // s)),
                    sm_count(x.device.index))
        return f"tile {p.th}x{p.tw} chunk {p.chunk} smem {p.smem} B"
    p = fs.launch_plan(x, fp)
    tiles = ", ".join(f"{st.th}x{st.tw}" for st in p.stages)
    dw = f"; avd/pool {p.dw_th}x{p.dw_tw}" if s == 2 else ""
    return (f"tiles {tiles}{dw}; smem {p.smem} B, {p.blocks_per_sm} blocks "
            f"an SM, grid {p.grid}")


def phase_stdc_kernel(device):
    """fused_cat_s1 / fused_cat_s2 against fused_cat_bottleneck_plain
    (TF32 off): fp32 within 1e-4 of max|plain|, bf16 within 2e-2 of
    max|plain| (tests/test_fused_stdc.py:32: both round every intermediate
    to bf16, and an fp32 sum in another order can flip a rounding, which
    the next layer carries on). Two runs bit-identical; one launch per
    call. Returns the largest |kernel - plain| of each stride."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.models.stdcnet import (
        CatBottleneck)
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_stdc as fs

    max_err = {1: 0.0, 2: 0.0}
    launches = {1: 0, 2: 0}
    before = {1: fs.S1_LAUNCHES, 2: fs.S2_LAUNCHES}
    for n, (name, stride, shape, chans) in enumerate(stdc_cases()):
        block = seed_cat_block(CatBottleneck(shape[1], sum(chans), 4, stride),
                               n).to(device)
        x32 = torch.from_numpy(np.random.default_rng(n).standard_normal(
            shape).astype(np.float32)).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            fp = fs.fold_cat_params(block, dtype)
            x = x32.to(dtype)
            got = fs.fused_cat_bottleneck(x, fp)
            again = fs.fused_cat_bottleneck(x, fp)
            launches[stride] += 2
            with fp32_math():
                want = fs.fused_cat_bottleneck_plain(x, fp)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            peak = want.float().abs().max().item()
            rel = 1e-4 if dtype == torch.float32 else 2e-2
            tag = str(dtype).replace("torch.", "")
            log("stdc-kernel", f"{name} s{stride} {shape} {tag}: "
                f"{stdc_plan_text(fs, x, fp)}; max|kernel-"
                f"plain| {err:.3e} = {err / max(peak, 1e-30):.3e} of max|plain|"
                f" {peak:.3e} (bound {rel:g}); rerun bit-identical "
                f"{torch.equal(got, again)}")
            check(got.shape == want.shape and got.dtype == dtype,
                  f"{name}: bad output {got.shape} {got.dtype}")
            check(torch.equal(got, again), f"{name} {tag}: two runs differ")
            check(err <= rel * peak, f"{name} {tag}: kernel off the plain "
                  f"version by {err}")
            max_err[stride] = max(max_err[stride], err)
    got_launches = {1: fs.S1_LAUNCHES - before[1], 2: fs.S2_LAUNCHES - before[2]}
    check(got_launches == launches,
          f"S1/S2_LAUNCHES rose by {got_launches}, expected {launches}")
    log("stdc-kernel", f"{len(stdc_cases())} shapes x fp32+bf16 within bounds;"
        f" max |kernel-plain| s1 {max_err[1]:.3e}, s2 {max_err[2]:.3e}; "
        f"launches {launches}")
    return max_err


def copy_counts():
    """The copy kernels' launch counters, copy_bounce by ring depth."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import copy_probe as cp

    return {"copy_block": cp.BLOCK_LAUNCHES, "copy_direct": cp.DIRECT_LAUNCHES,
            **{f"copy_bounce n_slots={n}": cp.BOUNCE_LAUNCHES[n]
               for n in cp.SLOTS}}


def copy_against_library(fns, x, bufs, card):
    """Each copy kernel of ``fns`` against ``copy_`` in turns A B B A
    (kernel, copy_, copy_, kernel), each turn timed by the probe's chain
    protocol (``time_chain``: the wrappers' host path included) and as a
    replay of the same chain captured once in a CUDA graph (``time_graph``:
    device only). The kernel is slower than ``copy_`` if its mean graph
    time exceeds ``copy_``'s by more than the turns' spread (the larger
    difference between a side's two turns, relative). Returns, per kernel,
    the mean graph-replay ms per copy of the kernel and of ``copy_`` and
    the four turns of each protocol."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.tools import probe_copy

    chain = probe_copy.CHAIN

    def library(s, d):
        return d.copy_(s)

    fns = {**fns, "copy_": library}
    graphs = {name: probe_copy.chain_graph(fn, x, bufs)
              for name, fn in fns.items()}
    out = {}
    for name in graphs:
        if name == "copy_":
            continue
        turns = {"chain": [], "graph": []}
        for which in (name, "copy_", "copy_", name):
            turns["chain"].append(probe_copy.time_chain(fns[which], x, bufs)
                                  / chain)
            turns["graph"].append(probe_copy.time_graph(graphs[which])
                                  / chain)
        mean = {p: ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2)
                for p, t in turns.items()}
        g = turns["graph"]
        spread = max(abs(g[0] - g[3]) / mean["graph"][0],
                     abs(g[1] - g[2]) / mean["graph"][1])
        ratio = mean["graph"][0] / mean["graph"][1]
        verdict = ("slower than copy_" if ratio - 1 > spread
                   else "not slower than copy_")
        log("copy-probe", f"{name} against copy_, turns A B B A, ms per copy:"
            f" chain {[round(t, 4) for t in turns['chain']]}, graph replay "
            f"{[round(t, 4) for t in g]}; graph ratio {ratio:.4f}, spread "
            f"{spread:.4f}: {verdict}; chain ratio "
            f"{mean['chain'][0] / mean['chain'][1]:.4f}; the host path costs"
            f" {mean['chain'][0] - mean['graph'][0]:.4f} ms per copy in the "
            f"chain ({mean['chain'][1] - mean['graph'][1]:.4f} for copy_) | "
            f"{card}")
        out[name] = {"graph_ms": mean["graph"][0],
                     "library_graph_ms": mean["graph"][1],
                     "abba_chain_ms": turns["chain"],
                     "abba_graph_ms": turns["graph"]}
    del graphs
    torch.cuda.empty_cache()
    return out


def phase_copy_probe(device, card):
    """Every variant of the probe's sweep (copy_block; copy_direct at each
    span length; copy_bounce at every ring: depth, stores left unread,
    chunk, blocks per SM, static or dynamic) against ``x.clone()``, bit for
    bit, into a new tensor and into ``out``, at the probe's 16384x8192 bf16
    and at edge sizes (one 16-byte vector, ragged last chunks and tiles,
    fewer tiles and chunks than blocks, uneven spans with a ragged tail);
    then the probe_copy entry point at full size with the counts reset just
    before and read just after; then the plain version and the two library
    yardsticks, ``copy_`` into a buffer and ``x + 0``, by the probe's
    protocol; then the three kernels at their defaults against ``copy_`` in
    turns A B B A, by the probe's protocol and as CUDA-graph replays.
    Returns the launches, the probe's times, the others' ms per copy, the
    bound, the largest error and the turns against ``copy_``."""
    import functools

    import torch

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import copy_probe as cp
    from dasemanticsegmentationaml_tpu_torch.tools import probe_copy

    variants = probe_copy.variants()
    counter = {label: next(k for k in copy_counts() if label.startswith(k))
               for label, _ in variants}
    full = probe_copy.ROWS * probe_copy.COLS
    # copy_direct's uneven spans with a ragged last tile: 1786 whole tiles
    # and 77 vectors
    uneven = 8 * (cp.DIRECT_TILE * 1786 + 77)
    sizes = (full, 8, 8 * 1000 + 8, 3 * 4096 + 24, 4 * 1024 * 1024 + 8,
             uneven)
    before = copy_counts()
    max_err = 0.0
    for n in sizes:
        x = probe_copy.seeded_buffer(1, n, device, seed=n % 7).view(-1)
        want = cp.copy_plain(x)
        out = torch.empty_like(x)
        for label, fn in variants:
            out.fill_(float("nan"))
            for got in (fn(x, None), fn(x, out)):
                torch.cuda.synchronize()
                max_err = max(max_err, (got.float() - want.float()).abs()
                              .max().item())
                check(torch.equal(got.view(torch.int16),
                                  want.view(torch.int16)),
                      f"{label} differs from x.clone() at {n} values")
        del x, want, out, got
    rose = {k: v - before[k] for k, v in copy_counts().items()}
    expected = {k: 2 * len(sizes) * list(counter.values()).count(k)
                for k in before}
    check(rose == expected,
          f"copy counters rose by {rose}, expected {expected}")
    log("copy-probe", f"{len(variants)} variants x {len(sizes)} sizes (bf16,"
        f" {sizes}) bit-identical to x.clone(), into a new tensor and into "
        f"out (max |kernel - plain| {max_err}); counters {rose}")

    cp.BLOCK_LAUNCHES = cp.DIRECT_LAUNCHES = 0
    cp.BOUNCE_LAUNCHES = {n: 0 for n in cp.SLOTS}
    results = probe_copy.main([])
    launches = {"copy_block": cp.BLOCK_LAUNCHES,
                "copy_direct": cp.DIRECT_LAUNCHES,
                "copy_bounce": cp.BOUNCE_LAUNCHES[BOUNCE_SLOTS],
                "copy_bounce_by_slots": dict(cp.BOUNCE_LAUNCHES)}
    log("copy-probe", f"the probe_copy entry point at {probe_copy.ROWS}x"
        f"{probe_copy.COLS} bf16: launches {launches}")
    check(all(v > 0 for v in cp.BOUNCE_LAUNCHES.values())
          and launches["copy_block"] > 0 and launches["copy_direct"] > 0,
          f"the probe did not launch every kernel: {launches}")

    x = probe_copy.seeded_buffer(probe_copy.ROWS, probe_copy.COLS, device)
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    nbytes = x.numel() * x.element_size()
    others = {}
    # x + 0 turns the buffer's -0.0 values into +0.0: held value for value
    for name, fn, bitwise in (
            ("plain x.clone()", lambda s, d: cp.copy_plain(s), True),
            ("library copy_", lambda s, d: d.copy_(s), True),
            ("library x + 0", lambda s, d: torch.add(s, 0, out=d), False)):
        ms = probe_copy.time_chain(fn, x, bufs,
                                   bitwise=bitwise) / probe_copy.CHAIN
        others[name] = ms
        log("copy-probe", f"{name}: {2 * nbytes / ms / 1e6:.1f} GB/s = "
            f"{2 * nbytes / ms * 1e3 / probe_copy.PEAK_BYTES_PER_S:.3f} of "
            f"3.35 TB/s ({ms:.4f} ms per copy, chain of {probe_copy.CHAIN}, best of "
            f"{probe_copy.REPS}); output "
            f"{'bit-identical' if bitwise else 'equal in value'} | {card}")
    bound = roofline(2 * nbytes, {})
    log("copy-probe", f"bound of one copy: {bound[0]:.4f} ms ({bound[1]})")
    turns = copy_against_library(
        {"copy_block": cp.copy_block, "copy_direct": cp.copy_direct,
         "copy_bounce": functools.partial(cp.copy_bounce,
                                          n_slots=BOUNCE_SLOTS)},
        x, bufs, card)
    del x, bufs
    torch.cuda.empty_cache()
    return launches, results, others, bound, max_err, turns


#: (rows, cols) of the roll's edge cases: rows of fewer vectors than a warp
#: has lanes, 520 (not a multiple of 32 vectors)
ROLL_SHAPES = ((8, 128), (1, 64), (8, 64), (1, 128), (1, 256), (8, 256),
               (3, 520))
ROLL_SHIFTS = (0, 1, -1, 63, 127, 128, 129, -300)


def phase_roll_kernel(device, card):
    """tile_roll against its plain version (slices + cat) and against
    ``torch.roll``, bit for bit, in its four dtypes at every edge shape and
    shift (C - 1, C and C + 1 too); then the roll_repro entry point with
    the count reset just before and read just after (one launch per
    dtype); then the kernel, its plain version and ``torch.roll`` (the
    library yardstick) at 16384x8192 bf16, shift 1, in turns A B B A, and
    the kernel at (8, 128)."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import tile_roll as tr
    from dasemanticsegmentationaml_tpu_torch.tools import roll_repro

    before = tr.LAUNCHES
    calls = 0
    max_err = 0.0
    for n, (rows, cols) in enumerate(ROLL_SHAPES):
        base = np.random.default_rng(n).integers(-3000, 3000, (rows, cols))
        for dtype in roll_repro.DTYPES:
            x = torch.from_numpy(base.astype(np.float32)).to(device, dtype)
            for shift in ROLL_SHIFTS + (cols - 1, cols, cols + 1):
                got = tr.tile_roll(x, shift)
                want = tr.tile_roll_plain(x, shift)
                calls += 1
                torch.cuda.synchronize()
                max_err = max(max_err, (got.double() - want.double()).abs()
                              .max().item())
                check(torch.equal(got, want)
                      and torch.equal(got, torch.roll(x, shift, 1)),
                      f"tile_roll differs from its plain version or "
                      f"torch.roll at {(rows, cols)} {dtype} shift {shift}")
    check(tr.LAUNCHES - before == calls,
          f"LAUNCHES rose by {tr.LAUNCHES - before}, expected {calls}")
    log("roll-kernel", f"{calls} cases ({len(ROLL_SHAPES)} shapes x fp32, "
        f"int32, bf16, int16 x {len(ROLL_SHIFTS) + 3} shifts) bit-identical "
        f"to the plain version and to torch.roll (max |kernel - plain| "
        f"{max_err}); LAUNCHES +{calls}")

    tr.LAUNCHES = 0
    roll_repro.main([])
    launches = tr.LAUNCHES
    log("roll-kernel", f"the roll_repro entry point at {roll_repro.ROWS}x"
        f"{roll_repro.COLS}, shift {roll_repro.SHIFT}: launches {launches}")
    check(launches == len(roll_repro.DTYPES),
          f"roll_repro launched {launches} times")

    rows, cols = 16384, 8192
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (rows, cols), dtype=np.float32)).to(device, torch.bfloat16)
    got = tr.tile_roll(x, 1)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int16),
                      tr.tile_roll_plain(x, 1).view(torch.int16)),
          "tile_roll differs from its plain version at 16384x8192")
    fns = {"kernel": lambda: tr.tile_roll(x, 1),
           "plain": lambda: tr.tile_roll_plain(x, 1),
           "library": lambda: torch.roll(x, 1, 1)}
    res = {}
    for which in ("plain", "kernel", "library", "library", "kernel", "plain"):
        res.setdefault(which, []).append(cuda_ms(fns[which], 20))
    mean = {k: sum(v) / len(v) for k, v in res.items()}
    nbytes = 2 * x.numel() * x.element_size()
    bound = roofline(nbytes, {})
    small = x[:8, :128].contiguous()
    small_ms = cuda_ms(lambda: tr.tile_roll(small, 1), 200)
    log("roll-kernel", f"({rows}, {cols}) bf16, shift 1: kernel "
        f"{mean['kernel']:.4f} ms {res['kernel']} = {nbytes / mean['kernel'] / 1e6:.1f}"
        f" GB/s, plain {mean['plain']:.4f} ms {res['plain']}, torch.roll "
        f"{mean['library']:.4f} ms {res['library']}; bound {bound[0]:.4f} ms "
        f"({bound[1]}); (8, 128): {small_ms:.4f} ms per call, back to back "
        f"| {card}")
    del x, got
    torch.cuda.empty_cache()
    return launches, mean, bound, max_err


def seeded_backbone(device):
    """A full-width STDCNet813 with seeded weights and running statistics,
    in eval mode."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.models.stdcnet import STDCNet813

    torch.manual_seed(0)
    net = STDCNet813()
    for i, block in enumerate(net.features[2:8]):
        seed_cat_block(block, 100 + i)
    return net.to(device).eval()


def stdc_input(device, backbone):
    """features[1]'s fp32 output (TF32 off) on a seeded 8x3x512x1024 batch:
    the input of features[2:8]."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math

    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (8, 3, 512, 1024)).astype(np.float32)).to(device)
    with torch.inference_mode(), fp32_math():
        return backbone.features[1](backbone.features[0](x))


def phase_stdc_path(device, backbone):
    """The fused bottleneck's path: fold features[2:8] (JAX
    fused_stdc.py:98) and run them as six launches on features[1]'s bf16
    output at batch 8, 1024x512. The counts are reset just before and read
    just after: three launches of each kernel. The result is held against
    the eager modules in fp32 (TF32 off) on the same input, within 5e-2 of
    max|fp32| (six bottlenecks deep in bf16), and against the six plain
    versions within 2e-2."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_stdc as fs

    x1 = stdc_input(device, backbone)
    with torch.inference_mode():
        with fp32_math():
            want = backbone.features[2:8](x1)
        folded = [fs.fold_cat_params(b, torch.bfloat16)
                  for b in backbone.features[2:8]]
        h = x1.to(torch.bfloat16)
        fs.S1_LAUNCHES = fs.S2_LAUNCHES = 0
        got = h
        for fp in folded:
            got = fs.fused_cat_bottleneck(got, fp)
        torch.cuda.synchronize()
        launches = {"fused_cat_s1": fs.S1_LAUNCHES,
                    "fused_cat_s2": fs.S2_LAUNCHES}
        with fp32_math():
            plain = h
            for fp in folded:
                plain = fs.fused_cat_bottleneck_plain(plain, fp)
    peak = want.abs().max().item()
    err = (got.float() - want).abs().max().item()
    err_plain = (got.float() - plain.float()).abs().max().item()
    log("stdc-path", f"features[2:8] as six fused launches, bf16, batch 8, "
        f"1024x512: out {tuple(got.shape)}; launches {launches}; max|fused - "
        f"eager fp32| {err:.3e} = {err / peak:.3e} of {peak:.3e} (bound 5e-2);"
        f" max|fused - plain chain| {err_plain:.3e} (bound "
        f"{2e-2 * peak:.3e})")
    check(tuple(got.shape) == (8, 1024, 16, 32)
          and torch.isfinite(got).all().item(), "bad fused chain output")
    check(launches == {"fused_cat_s1": 3, "fused_cat_s2": 3},
          f"the path launched {launches}, expected 3 of each")
    check(err <= 5e-2 * peak, "fused chain off the eager fp32 chain")
    check(err_plain <= 2e-2 * peak, "fused chain off the plain chain")
    return launches, h


def phase_model(device):
    import torch
    import torch.nn.functional as F

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import build_bisenet
    from dasemanticsegmentationaml_tpu_torch.ops.cuda.upsample_argmax import (
        upsample_argmax)

    cpu_model = build_bisenet(19, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in cpu_model.parameters())
    check(n_params == 11_550_496, f"param count {n_params}")
    model = copy.deepcopy(cpu_model).to(device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 512, 1024)).astype(np.float32))
    with torch.inference_mode(), fp32_math():
        log("model", f"fp32 check: cudnn.allow_tf32="
            f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}")
        got = [f.cpu() for f in model.features(x.to(device))]
        want = cpu_model.features(x)
        for name, g, w in zip(("out", "out16", "out32"), got, want):
            bound = 1e-3 * w.abs().max().item()
            err = (g - w).abs().max().item()
            log("model", f"features {name} {tuple(g.shape)}: max|gpu-cpu| "
                f"{err:.3e}, bound {bound:.3e}")
            check(err <= bound, f"features {name} off by {err}")
        xd = x.to(device)
        hw = xd.shape[2:]
        feat32 = model.features(xd)[0]
        pred32 = upsample_argmax(feat32, hw)
        up = F.interpolate(feat32, hw, mode="bilinear", align_corners=True)
        top2 = up.topk(2, dim=1).values
        margin = top2[:, 0] - top2[:, 1]
    with torch.inference_mode():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            feat16 = model.features(xd)[0]
        pred16 = upsample_argmax(feat16.contiguous(), hw)
    # With seeded random weights 1-2% of pixels are nearer a tie between
    # two classes than bf16 rounding reaches: the JAX reference's own bf16
    # run agrees with its fp32 run on 0.980 of pixels (same weights,
    # 2x256x512, on the CPU). So bf16 is held to its head-logit error, to
    # exact agreement wherever the fp32 top-2 margin exceeds twice that
    # error (the interpolation cannot move a logit by more than it), and
    # to 0.97 overall.
    err = (feat16.float() - feat32).abs().max()
    logit_err = (err / feat32.abs().max()).item()
    same = pred16 == pred32
    agree = same.float().mean().item()
    decisive = margin > 2 * err
    agree_decisive = same[decisive].float().mean().item()
    log("model", f"bf16 autocast vs fp32: head logits max|d|/max|fp32| "
        f"{logit_err:.3e} (bound 5e-2); predictions agree on {agree:.6f} of "
        f"pixels (bound 0.97) and on {agree_decisive:.6f} of the "
        f"{decisive.float().mean().item():.4f} whose fp32 top-2 margin "
        f"exceeds twice the logit error (bound 1.0)")
    check(logit_err <= 5e-2, f"bf16 logit error {logit_err}")
    check(agree_decisive == 1.0 and agree >= 0.97,
          f"bf16 agreement {agree}, decisive {agree_decisive}")
    return model


def write_cityscapes(root, mode="val", n=4, size=(512, 1024), seed=0):
    """tests/test_cli.py::_mk_cityscapes layout: images/<mode>/city/*.png +
    gtFine/<mode>/city/*_labelTrainIds.png, from a numpy seed."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for top in ("images", "gtFine"):
        os.makedirs(os.path.join(root, top, mode, "city"), exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(
            os.path.join(root, "images", mode, "city", f"c_{i:03d}.png"))
        Image.fromarray(rng.integers(0, 19, size, dtype=np.uint8),
                        mode="L").save(os.path.join(
                            root, "gtFine", mode, "city",
                            f"c_{i:03d}_labelTrainIds.png"))


def phase_slice():
    from dasemanticsegmentationaml_tpu_torch import cli
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua

    with tempfile.TemporaryDirectory() as root:
        write_cityscapes(root)
        argv = ["--root", root, "--domain_shift", "True",
                "--crop_height", "512", "--crop_width", "1024",
                "--eval_batch_size", "2"]
        ua.LAUNCHES = 0
        t0 = time.perf_counter()
        res = cli.main(argv + ["--dtype", "bfloat16", "--cuda", "0"])
        secs = time.perf_counter() - t0
        launches = ua.LAUNCHES
        log("slice", f"bf16 cuda:0 {res} in {secs:.2f} s host time "
            f"(set-up included); kernel launches {launches}")
        check(math.isfinite(res["miou"]) and 0.0 <= res["miou"] <= 1.0,
              f"bad mIoU {res['miou']}")
        check(launches > 0, "the main path did not launch the kernel")

        gpu = cli.main(argv + ["--dtype", "float32", "--cuda", "0"])
        cpu = cli.main(argv + ["--dtype", "float32", "--cuda", "cpu"])
        d_miou = abs(gpu["miou"] - cpu["miou"])
        d_prec = abs(gpu["precision"] - cpu["precision"])
        log("slice", f"fp32 cuda:0 {gpu} vs cpu {cpu}: |dmIoU| {d_miou:.3e},"
            f" |dprecision| {d_prec:.3e} (bound 1e-3)")
        check(d_miou <= 1e-3 and d_prec <= 1e-3, "fp32 gpu vs cpu CLI")
    return launches


def phase_train():
    """The supervised CLI at batch 8, 1024x512, bf16; returns the launch
    counts of its run."""
    import torch

    from dasemanticsegmentationaml_tpu_torch import cli
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import BiSeNet
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua
    from dasemanticsegmentationaml_tpu_torch.utils.weights import (
        load_reference_state)

    epochs, steps_per_epoch = 2, 2
    with tempfile.TemporaryDirectory() as root:
        write_cityscapes(root, "train", n=16, seed=1)
        write_cityscapes(root, "val", n=4)
        save = os.path.join(root, "checkpoints")
        log_path = os.path.join(root, "train.jsonl")
        argv = ["--root", root, "--batch_size", "8",
                "--num_epochs", str(epochs),
                "--max_steps_per_epoch", str(steps_per_epoch),
                "--validation_step", "1", "--checkpoint_step", "1",
                "--dtype", "bfloat16", "--cuda", "0",
                "--tensorboard", "False", "--save_model_path", save,
                "--jsonl_log", log_path]
        fc.FWD_LAUNCHES = fc.BWD_LAUNCHES = ua.LAUNCHES = 0
        t0 = time.perf_counter()
        res = cli.main(argv)
        secs = time.perf_counter() - t0
        launches = {"fused_ce_fwd": fc.FWD_LAUNCHES,
                    "fused_ce_bwd": fc.BWD_LAUNCHES,
                    "upsample_argmax": ua.LAUNCHES}
        with open(log_path) as f:
            losses = [json.loads(line)["loss"] for line in f]
        steps = epochs * steps_per_epoch
        log("train", f"supervised CLI, batch 8, 1024x512, bf16, {steps} "
            f"steps: {res}; epoch losses {losses}; {secs:.2f} s host time "
            f"(set-up, validation and checkpoints included); launches "
            f"{launches}")
        check(launches["fused_ce_fwd"] == 3 * steps
              and launches["fused_ce_bwd"] == 3 * steps,
              f"fused CE launches {launches}, expected {3 * steps} each")
        check(launches["upsample_argmax"] > 0,
              "validation did not launch upsample_argmax")
        check(len(losses) == epochs and all(map(math.isfinite, losses)),
              f"bad losses {losses}")
        best = os.path.join(save, "best.pth")
        check(os.path.exists(best)
              and os.path.exists(os.path.join(save, "latest.pth")),
              f"checkpoints missing: {os.listdir(save)}")
        n = len(load_reference_state(
            BiSeNet(19), torch.load(best, weights_only=True), strict=True))
        check(n == 216, f"best.pth holds {n} tensors")
        ev = cli.main(["--root", root, "--domain_shift", "True",
                       "--pretrain_path", best, "--dtype", "bfloat16",
                       "--cuda", "0"])
        d_miou = abs(ev["miou"] - res["miou"])
        log("train", f"--domain_shift on best.pth ({n} tensors, strict): "
            f"{ev}; |dmIoU| vs the trainer's final {d_miou:.3e} "
            f"(bound 1e-3)")
        check(d_miou <= 1e-3, "best.pth does not reproduce the mIoU")
    return launches


def write_gtav(root, n=16, size=(512, 1024), seed=2):
    """tests/test_cli.py::_mk_gtav layout: images/*.png + palettised
    labels/*.png holding raw GTA5 ids 0..34."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for top in ("images", "labels"):
        os.makedirs(os.path.join(root, top), exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(
            os.path.join(root, "images", f"{i:05d}.png"))
        lab = Image.fromarray(rng.integers(0, 35, size, dtype=np.uint8),
                              mode="P")
        lab.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tolist())
        lab.save(os.path.join(root, "labels", f"{i:05d}.png"))


#: the DA CLI runs of phase_da: (name, flags)
DA_RUNS = (("FC D, interleaved", ["--depthwise", "False",
                                  "--da_step_mode", "interleaved"]),
           ("DW+BN D, combined", ["--depthwise", "True", "--batch_norm", "True",
                                  "--da_step_mode", "combined"]))


def phase_da():
    """The DA CLI at batch 8, 1024x512, bf16, 2 epochs of 2 steps, in both
    step modes; the CE kernels' counts are reset before each run and read
    after it."""
    import torch

    from dasemanticsegmentationaml_tpu_torch import cli
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua

    epochs, steps_per_epoch = 2, 2
    steps = epochs * steps_per_epoch
    # the two heads that do not feed D go through the fused CE once each
    # per step, forward and backward, in both modes: 2 x 4 = 8
    expect = 2 * steps
    with tempfile.TemporaryDirectory() as root:
        gta, cs = os.path.join(root, "gta5"), os.path.join(root, "cityscapes")
        write_gtav(gta, n=16)
        write_cityscapes(cs, "train", n=16, seed=1)
        write_cityscapes(cs, "val", n=4)
        for n, (name, flags) in enumerate(DA_RUNS):
            save = os.path.join(root, f"ck{n}")
            log_path = os.path.join(root, f"da{n}.jsonl")
            argv = ["--domain_adaptation", "True", "--root", cs,
                    "--root_source", gta, "--root_target", cs,
                    "--batch_size", "8", "--num_epochs", str(epochs),
                    "--max_steps_per_epoch", str(steps_per_epoch),
                    "--validation_step", "1", "--checkpoint_step", "1",
                    "--dtype", "bfloat16", "--cuda", "0",
                    "--tensorboard", "False", "--save_model_path", save,
                    "--jsonl_log", log_path] + flags
            fc.FWD_LAUNCHES = fc.BWD_LAUNCHES = ua.LAUNCHES = 0
            t0 = time.perf_counter()
            res = cli.main(argv)
            secs = time.perf_counter() - t0
            launches = {"fused_ce_fwd": fc.FWD_LAUNCHES,
                        "fused_ce_bwd": fc.BWD_LAUNCHES,
                        "upsample_argmax": ua.LAUNCHES}
            with open(log_path) as f:
                rows = [json.loads(line) for line in f]
            seg = [r["loss_seg"] for r in rows]
            adv = [r["loss_adv"] for r in rows]
            log("da", f"{name}: DA CLI, batch 8, 1024x512, bf16, {steps} "
                f"steps: {res}; epoch loss_seg {seg}, loss_D1 {adv}; "
                f"{secs:.2f} s host time (set-up, validation and checkpoints "
                f"included); launches {launches}")
            check(launches["fused_ce_fwd"] == expect
                  and launches["fused_ce_bwd"] == expect,
                  f"fused CE launches {launches}, expected {expect} each")
            check(launches["upsample_argmax"] > 0,
                  "validation did not launch upsample_argmax")
            check(len(seg) == epochs
                  and all(map(math.isfinite, seg + adv)),
                  f"bad losses {seg} {adv}")
            names = set(os.listdir(save))
            check({"GTA5_1.pth", "GTA5_1_D1.pth"} <= names,
                  f"checkpoints missing: {names}")
            g_keys = torch.load(os.path.join(save, "GTA5_1.pth"),
                                weights_only=True)
            check(len(g_keys) == 216
                  and all(k.startswith("module.") for k in g_keys),
                  "GTA5_1.pth is not 216 module.-prefixed tensors")
            ev = cli.main(["--root", cs, "--domain_shift", "True",
                           "--pretrain_path", os.path.join(save, "GTA5_1.pth"),
                           "--dtype", "bfloat16", "--cuda", "0"])
            log("da", f"{name}: --domain_shift on GTA5_1.pth: {ev}")
            check(math.isfinite(ev["miou"]) and 0.0 <= ev["miou"] <= 1.0,
                  f"bad mIoU {ev}")


def ce_float64(logits, labels, out_hw, ignore_index):
    """fp64 CE(ignore) of the align_corners upsample (the fp64 step)."""
    import torch
    import torch.nn.functional as F

    up = F.interpolate(logits, out_hw, mode="bilinear", align_corners=True)
    valid = (labels != ignore_index) & (labels >= 0) & (labels < up.shape[1])
    loss = F.cross_entropy(up, torch.where(valid, labels, 0).long(),
                           reduction="none")
    return torch.where(valid, loss, 0.0).sum() / valid.sum().clamp_min(1)


def phase_train_parity(device):
    """One fp32 SGD step (lr 0.01, momentum 0.9, wd 1e-4) at 2x3x1024x512
    from the same seeded weights, on the card (TF32 off) and on the CPU,
    plus the same step in fp64 on the CPU. Bounds, of each leaf's update
    (tests/test_train_equivalence.py:79-80, step 1): loss rtol 1e-4;
    global l2 of card - CPU < 0.02; running statistics < 0.02; each leaf
    < 0.1 where the CPU's fp32 step is within 0.05 of the fp64 one, and on
    every leaf the card's step within 0.1 of the fp64 one; the ImageNet
    head bit-identical."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        build_bisenet, trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.train.optim import make_optimizer
    from dasemanticsegmentationaml_tpu_torch.train.supervised import (
        make_train_step)

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 1024, 512)).astype(np.float32)
    y = np.where(rng.random((2, 1024, 512)) < 0.05, 255,
                 rng.integers(0, 19, (2, 1024, 512))).astype(np.int32)

    def seeded():
        return build_bisenet(19, device="cpu",
                             generator=torch.Generator().manual_seed(0))

    def state_of(model):
        return {k: v.detach().to("cpu", torch.float64, copy=True).numpy()
                for k, v in model.state_dict().items()
                if not k.endswith("num_batches_tracked")}

    def one_step(dev, dtype, **kw):
        model = seeded().to(device=dev, dtype=dtype).train()
        opt = make_optimizer("sgd", trainable_parameters(model), 0.01,
                             momentum=0.9, weight_decay=1e-4)
        t0 = time.perf_counter()
        loss = make_train_step(model, opt, **kw)(
            torch.from_numpy(x).to(dev, dtype), torch.from_numpy(y).to(dev))
        loss = loss.item()
        return loss, state_of(model), time.perf_counter() - t0

    init = state_of(seeded())
    with fp32_math():
        card_loss, card, t_card = one_step(device, torch.float32)
    cpu_loss, cpu, t_cpu = one_step("cpu", torch.float32)
    exact_loss, exact, t_exact = one_step("cpu", torch.float64, ce=ce_float64)
    log("train-parity", f"fp32 step loss: card {card_loss:.7f}, CPU "
        f"{cpu_loss:.7f}, CPU fp64 {exact_loss:.7f} (card {t_card:.1f} s, "
        f"CPU {t_cpu:.1f} s, fp64 {t_exact:.1f} s, first calls)")
    check(abs(card_loss - cpu_loss) <= 1e-4 * abs(cpu_loss), "loss off")
    sq_diff = sq_upd = 0.0
    worst = {"running": (0.0, ""), "leaf": (0.0, ""), "card_vs_fp64": (0.0, "")}
    n_frozen = n_tight = n_loose = 0
    for key, base in init.items():
        upd = np.abs(cpu[key] - base).max()
        if upd < 1e-12:
            check(np.array_equal(card[key], base)
                  and np.array_equal(exact[key], base), f"{key} moved")
            n_frozen += 1
            continue
        err = np.abs(card[key] - cpu[key]).max() / upd
        if key.endswith(("running_mean", "running_var")):
            worst["running"] = max(worst["running"], (err, key))
            check(err < 0.02, f"running stat {key} off by {err:.3f}")
            continue
        sq_diff += float(np.sum((card[key] - cpu[key]) ** 2))
        sq_upd += float(np.sum((cpu[key] - base) ** 2))
        exact_upd = np.abs(exact[key] - base).max()
        card_miss = np.abs(card[key] - exact[key]).max() / exact_upd
        cpu_miss = np.abs(cpu[key] - exact[key]).max() / exact_upd
        worst["card_vs_fp64"] = max(worst["card_vs_fp64"], (card_miss, key))
        check(card_miss < 0.1, f"{key}: card step {card_miss:.3f} of its "
              f"update off the fp64 step")
        if cpu_miss < 0.05:
            worst["leaf"] = max(worst["leaf"], (err, key))
            check(err < 0.1, f"{key}: card vs CPU {err:.3f} of its update")
            n_tight += 1
        else:
            n_loose += 1
    g = math.sqrt(sq_diff / max(sq_upd, 1e-30))
    log("train-parity", f"card vs CPU: global l2 {g:.4f} (bound 0.02); "
        f"worst running stat {worst['running'][0]:.4f} at "
        f"{worst['running'][1]} (bound 0.02); worst leaf {worst['leaf'][0]:.4f}"
        f" at {worst['leaf'][1]} over {n_tight} leaves (bound 0.1; {n_loose} "
        f"leaves where the CPU's fp32 step misses fp64 by 0.05 or more); card "
        f"vs fp64 worst {worst['card_vs_fp64'][0]:.4f} at "
        f"{worst['card_vs_fp64'][1]} (bound 0.1); {n_frozen} frozen leaves "
        f"bit-identical")
    check(g < 0.02, f"global l2 {g}")
    check(n_frozen >= 7, f"only {n_frozen} frozen leaves")


def phase_da_parity(device):
    """One fp32 DA step (DW+BN discriminator, the 4-phase step, lr 0.01 /
    1e-3, lambda 1e-3) at 2x3x1024x512 from the same seeded weights, on
    the card (TF32 off), on the CPU and in fp64 on the CPU. Bounds: the
    four losses within rtol 1e-4 of the CPU's; G as train-parity (global
    l2 of card - CPU < 0.02 of the update, each leaf within 0.1 of its
    update where the CPU's fp32 step is within 0.05 of fp64, the card's
    within 0.1 of fp64 on every leaf, frozen leaves bit-identical); D's
    global l2 < 0.25 of its update (test_train_equivalence.py:379-380: its
    first Adam step is sign-saturated), leaving out the conv biases that
    feed a BN, whose gradient is zero up to rounding; running statistics
    as tests/test_torch_da.py holds them, within a global l2 of 0.05 and
    0.3 per leaf of their update (their phase-2 update sees G after its
    phase-1 update, which rounding moves)."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        build_bisenet, trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.models.discriminator import (
        build_discriminator)
    from dasemanticsegmentationaml_tpu_torch.train.adversarial import (
        make_da_step)
    from dasemanticsegmentationaml_tpu_torch.train.optim import make_optimizer

    rng = np.random.default_rng(4)
    xs = rng.standard_normal((2, 3, 1024, 512)).astype(np.float32)
    xt = rng.standard_normal((2, 3, 1024, 512)).astype(np.float32)
    y = np.where(rng.random((2, 1024, 512)) < 0.05, 255,
                 rng.integers(0, 19, (2, 1024, 512))).astype(np.int32)
    bn_fed = {f"conv{i}_{s}.bias" for i in range(1, 5) for s in "dp"}

    def state_of(m):
        return {k: v.detach().to("cpu", torch.float64, copy=True).numpy()
                for k, v in m.state_dict().items()
                if not k.endswith("num_batches_tracked")}

    def nets():
        g = build_bisenet(19, device="cpu",
                          generator=torch.Generator().manual_seed(0))
        d = build_discriminator(19, True, True,
                                generator=torch.Generator().manual_seed(2))
        return g, d

    def one_step(dev, dtype, **kw):
        g, d = (m.to(device=dev, dtype=dtype).train() for m in nets())
        g_opt = make_optimizer("sgd", trainable_parameters(g), 0.01,
                               momentum=0.9, weight_decay=5e-4)
        d_opt = make_optimizer("adam", d.parameters(), 1e-3, betas=(0.9, 0.99))
        step = make_da_step(g, d, g_opt, d_opt, lambda_adv=1e-3, **kw)
        t0 = time.perf_counter()
        m = step(torch.from_numpy(xs).to(dev, dtype),
                 torch.from_numpy(y).to(dev),
                 torch.from_numpy(xt).to(dev, dtype))
        m = {k: v.item() for k, v in m.items()}
        return m, state_of(g), state_of(d), time.perf_counter() - t0

    g0, d0 = (state_of(m) for m in nets())
    with fp32_math():
        card_m, card_g, card_d, t_card = one_step(device, torch.float32)
    cpu_m, cpu_g, cpu_d, t_cpu = one_step("cpu", torch.float32)
    exact_m, exact_g, exact_d, t_exact = one_step("cpu", torch.float64,
                                                  ce=ce_float64)
    log("da-parity", f"fp32 DA step: card {card_m}, CPU {cpu_m}, CPU fp64 "
        f"{exact_m} (card {t_card:.1f} s, CPU {t_cpu:.1f} s, fp64 "
        f"{t_exact:.1f} s, first calls)")
    for key, want in cpu_m.items():
        check(abs(card_m[key] - want) <= 1e-4 * abs(want),
              f"{key}: card {card_m[key]} vs CPU {want}")
    worst = {"running": (0.0, ""), "leaf": (0.0, ""), "card_vs_fp64": (0.0, "")}
    n_frozen = n_tight = n_loose = 0
    sq = {"g": [0.0, 0.0], "d": [0.0, 0.0], "rs": [0.0, 0.0]}
    for net, init, card, cpu, exact in (("g", g0, card_g, cpu_g, exact_g),
                                        ("d", d0, card_d, cpu_d, exact_d)):
        for key, base in init.items():
            upd = np.abs(cpu[key] - base).max()
            if upd < 1e-12:
                check(np.array_equal(card[key], base)
                      and np.array_equal(exact[key], base), f"{key} moved")
                n_frozen += 1
                continue
            err = np.abs(card[key] - cpu[key]).max() / upd
            if key.endswith(("running_mean", "running_var")):
                worst["running"] = max(worst["running"], (err, f"{net}:{key}"))
                check(err < 0.3, f"running stat {net}:{key} off by {err:.3f}")
                sq["rs"][0] += float(np.sum((card[key] - cpu[key]) ** 2))
                sq["rs"][1] += float(np.sum((cpu[key] - base) ** 2))
                continue
            if net == "d":
                if key not in bn_fed:
                    sq["d"][0] += float(np.sum((card[key] - cpu[key]) ** 2))
                    sq["d"][1] += float(np.sum((cpu[key] - base) ** 2))
                continue
            sq["g"][0] += float(np.sum((card[key] - cpu[key]) ** 2))
            sq["g"][1] += float(np.sum((cpu[key] - base) ** 2))
            exact_upd = np.abs(exact[key] - base).max()
            card_miss = np.abs(card[key] - exact[key]).max() / exact_upd
            cpu_miss = np.abs(cpu[key] - exact[key]).max() / exact_upd
            worst["card_vs_fp64"] = max(worst["card_vs_fp64"], (card_miss, key))
            check(card_miss < 0.1, f"{key}: card step {card_miss:.3f} of its "
                  f"update off the fp64 step")
            if cpu_miss < 0.05:
                worst["leaf"] = max(worst["leaf"], (err, key))
                check(err < 0.1, f"{key}: card vs CPU {err:.3f} of its update")
                n_tight += 1
            else:
                n_loose += 1
    g_l2, d_l2, rs_l2 = (math.sqrt(a / max(b, 1e-30)) for a, b in sq.values())
    log("da-parity", f"card vs CPU: G global l2 {g_l2:.4f} (bound 0.02); D "
        f"global l2 {d_l2:.4f} (bound 0.25); running statistics global l2 "
        f"{rs_l2:.4f} (bound 0.05), worst {worst['running'][0]:.4f} at "
        f"{worst['running'][1]} (bound 0.3); "
        f"worst G leaf {worst['leaf'][0]:.4f} at {worst['leaf'][1]} over "
        f"{n_tight} leaves (bound 0.1; {n_loose} leaves where the CPU's fp32 "
        f"step misses fp64 by 0.05 or more); card vs fp64 worst "
        f"{worst['card_vs_fp64'][0]:.4f} at {worst['card_vs_fp64'][1]} (bound "
        f"0.1); {n_frozen} frozen leaves bit-identical")
    check(g_l2 < 0.02, f"G global l2 {g_l2}")
    check(d_l2 < 0.25, f"D global l2 {d_l2}")
    check(rs_l2 < 0.05, f"running statistics global l2 {rs_l2}")
    check(n_frozen >= 7, f"only {n_frozen} frozen leaves")


def time_stdc(device, backbone, h, card, fns=None):
    """Two versions of the fused CatBottleneck, A and B (``fns``: name ->
    (fold, call), in that order; by default the plain version and the
    kernel), on each of features[2:8] at bf16, batch 8, in turns A B B A: by
    the chain (``cuda_ms``: the wrapper's host path included) and by device
    time alone (``device_ms``: the kernel's profiler sums; every kernel of
    the plain version); beside them the eager cuDNN module (autocast, eval),
    the yardstick, both ways. By default each bottleneck in fp32 too,
    kernel against plain (TF32 off, as it is checked). Then the
    features[2:8] chain on ``h``: the eager modules against each version's
    six launches (the plain version's excepted), in turns, both ways.
    Returns, per (bottleneck, dtype) and for "chain", the means by name and
    by (name, "device")."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_stdc as fs

    fns = fns or {"plain": (fs.fold_cat_params,
                            fs.fused_cat_bottleneck_plain),
                  "kernel": (fs.fold_cat_params, fs.fused_cat_bottleneck)}
    a, b = fns

    def timed(res, name, call, fused):
        res.setdefault(name, []).append(cuda_ms(call, 10))
        ms, _ = device_ms(call, STDC_KERNELS if fused else None, n=10)
        res.setdefault((name, "device"), []).append(ms)

    def line(res, names):
        return "; ".join(
            f"{n} device {sum(res[(n, 'device')]) / len(res[(n, 'device')]):.4f}"
            f" ms {[round(t, 4) for t in res[(n, 'device')]]}, chain "
            f"{sum(res[n]) / len(res[n]):.4f} ms "
            f"{[round(t, 4) for t in res[n]]}" for n in names)

    times = {}
    for n, (name, stride, shape, chans) in enumerate(stdc_cases()[:6]):
        block = backbone.features[n + 2]
        x32 = torch.from_numpy(np.random.default_rng(n).standard_normal(
            shape).astype(np.float32)).to(device)
        x = x32.to(torch.bfloat16)
        folded = {k: fold(block, torch.bfloat16)
                  for k, (fold, _) in fns.items()}

        def eager():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                block(x)

        res = {}
        with torch.inference_mode():
            for which in (a, b, b, a):
                timed(res, which, functools.partial(
                    fns[which][1], x, folded[which]), which != "plain")
            timed(res, "eager", eager, False)
        times[(name, "bfloat16")] = {k: sum(v) / len(v)
                                     for k, v in res.items()}
        if "kernel" in fns:
            phases = stdc_phase_ms(fs, x, folded["kernel"])
            names = (["entry", "avd_pool"] if stride == 2 else ["entry"]) + [
                "x2", "x3", "x4"]
            log("timing", f"fused CatBottleneck {name} bfloat16, the "
                f"kernel's phases (device ms): " + ", ".join(
                    f"{p} {t:.4f}" for p, t in zip(names, phases))
                + f" | {card}")
        bound = bound_cat(stride, shape[1:], chans, shape[0], 2)
        plan = fs.launch_plan(x, folded["kernel"])
        log("timing", f"fused CatBottleneck {name} s{stride} {shape} bfloat16"
            f", turns {a} {b} {b} {a}: {line(res, (a, b))}; eager cuDNN "
            f"module (autocast, eval): {line(res, ('eager',))}; bound "
            f"{bound[0]:.4f} ms ({bound[1]}); the kernel's plan does "
            f"{cat_macs_done(plan, shape[0]) / 1e9:.2f} GMAC of "
            f"{cat_macs(stride, shape[1:], chans, shape[0]) / 1e9:.2f} useful"
            f" | {card}")
        if "plain" not in fns:
            continue
        fp = fs.fold_cat_params(block, torch.float32)
        res = {}
        with torch.inference_mode(), fp32_math():
            for which in ("plain", "kernel", "kernel", "plain"):
                fn = (fs.fused_cat_bottleneck if which == "kernel"
                      else fs.fused_cat_bottleneck_plain)
                res.setdefault(which, []).append(
                    cuda_ms(lambda: fn(x32, fp), 10))
        mean = {k: sum(v) / len(v) for k, v in res.items()}
        times[(name, "float32")] = mean
        log("timing", f"fused CatBottleneck {name} s{stride} {shape} float32"
            f": kernel {mean['kernel']:.4f} ms {res['kernel']}, plain "
            f"{mean['plain']:.4f} ms {res['plain']} | {card}")

    chains = {"eager": (None, None)}
    chains.update({k: v for k, v in fns.items() if k != "plain"})
    folded = {k: [fold(blk, torch.bfloat16) for blk in backbone.features[2:8]]
              for k, (fold, _) in chains.items() if fold is not None}

    def chain(which):
        if which == "eager":
            with torch.autocast("cuda", dtype=torch.bfloat16):
                backbone.features[2:8](h)
            return
        out = h
        for fp in folded[which]:
            out = chains[which][1](out, fp)

    order = [k for k in chains if k != "eager"] + ["eager"]
    res = {}
    with torch.inference_mode():
        for which in order + order[::-1]:
            timed(res, which, functools.partial(chain, which),
                  which != "eager")
    mean = {k: sum(v) / len(v) for k, v in res.items()}
    times["chain"] = mean
    log("timing", f"features[2:8], bf16, batch 8, 1024x512: "
        f"{line(res, order)}; " + ", ".join(
            f"{k} / eager device {mean[(k, 'device')] / mean[('eager', 'device')]:.3f}"
            f" chain {mean[k] / mean['eager']:.3f}" for k in order[:-1])
        + f" | {card}")
    return times


def time_da_step(device, card):
    """The bf16 DA step (FC discriminator, the 4-phase step) at batch 8,
    1024x512: ms/step, images/s, peak memory, then a profiler pass."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.data.pipeline import prepare_batch
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        build_bisenet, trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.models.discriminator import (
        build_discriminator)
    from dasemanticsegmentationaml_tpu_torch.train.adversarial import (
        make_da_step)
    from dasemanticsegmentationaml_tpu_torch.train.optim import make_optimizer

    g = build_bisenet(19, device=device,
                      generator=torch.Generator().manual_seed(0)).train()
    d = build_discriminator(19, device=device,
                            generator=torch.Generator().manual_seed(2)).train()
    g_opt = make_optimizer("sgd", trainable_parameters(g), 0.01,
                           momentum=0.9, weight_decay=5e-4)
    d_opt = make_optimizer("adam", d.parameters(), 1e-3, betas=(0.9, 0.99))
    step = make_da_step(g, d, g_opt, d_opt, lambda_adv=1e-3,
                        amp_dtype=torch.bfloat16)
    rng = np.random.default_rng(6)
    labels = np.where(rng.random((8, 1024, 512)) < 0.05, 255,
                      rng.integers(0, 35, (8, 1024, 512))).astype(np.uint8)
    xs, ys = prepare_batch(
        rng.integers(0, 256, (8, 1024, 512, 3), dtype=np.uint8), labels,
        device=device, remap=True, dtype=torch.bfloat16)
    xt, _ = prepare_batch(
        rng.integers(0, 256, (8, 1024, 512, 3), dtype=np.uint8), labels,
        device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    ms_runs = [cuda_ms(lambda: step(xs, ys, xt), 10, warmup=2)
               for _ in range(2)]
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    ms = sum(ms_runs) / len(ms_runs)
    log("timing", f"DA step, bf16, batch 8, 1024x512, FC D, interleaved: "
        f"{ms:.3f} ms/step {ms_runs} = {8000.0 / ms:.1f} images/s, peak "
        f"memory {peak:.2f} GiB | {card}")
    profile_steps(lambda: step(xs, ys, xt),
                  "DA step, bf16, batch 8, FC D, interleaved", card,
                  watch=CE_KERNELS["fwd"] + CE_KERNELS["bwd"])
    return ms, peak


def phase_timing(device, model, card):
    import torch

    from dasemanticsegmentationaml_tpu_torch.data.pipeline import prepare_batch
    from dasemanticsegmentationaml_tpu_torch.train.evaluate import predict

    times = {"argmax": time_argmax(device, card)}

    # the CLI's layout (NCHW) against channels_last, in turns A B B A
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (8, 512, 1024, 3), dtype=np.uint8)
    labels = np.zeros((8, 512, 1024), np.uint8)
    runs = {}
    for fmt in (torch.contiguous_format, torch.channels_last,
                torch.channels_last, torch.contiguous_format):
        m = model.to(memory_format=fmt)
        x, _ = prepare_batch(images, labels, device=device,
                             dtype=torch.bfloat16, memory_format=fmt)
        torch.cuda.reset_peak_memory_stats(device)
        with torch.inference_mode():
            ms = cuda_ms(lambda: predict(m, x, True, torch.bfloat16), 20)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        runs.setdefault(str(fmt).replace("torch.", ""), []).append(ms)
        log("timing", f"features + kernel, bf16 autocast, batch 8, 512x1024, "
            f"{str(fmt).replace('torch.', '')}: {ms:.3f} ms/batch = "
            f"{8000.0 / ms:.1f} images/s, peak memory {peak:.2f} GiB | {card}")
    model.to(memory_format=torch.contiguous_format)
    for fmt, ms in runs.items():
        log("timing", f"features + kernel, bf16, batch 8, {fmt}: mean "
            f"{sum(ms) / len(ms):.3f} ms/batch = "
            f"{8000.0 * len(ms) / sum(ms):.1f} images/s | {card}")
    profile_eval(model, x, card)
    times["ce"] = time_ce(device, card)
    times["train"] = time_train_step(device, card)
    return times


def profile_steps(run_one, what, card, n=10, watch=()):
    """Where the time of ``run_one`` goes: device busy share, kernels per
    call, host enqueue time, the heaviest kernels (torch.profiler) and the
    share of device time of the kernels whose names contain one of
    ``watch``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        for _ in range(n):
            run_one()
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    run_one()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels) // n
    log("profile", f"{what}, {n} calls: device busy {busy_ms / wall_ms:.3f} "
        f"of {wall_ms:.2f} ms (profiled); {launches} kernels/call; host "
        f"enqueue of one call {enqueue_ms:.2f} ms vs {busy_ms / n:.3f} ms of "
        f"kernels | {card}")
    if watch:
        hits = [e for e in kernels if any(m in e.key for m in watch)]
        ms = sum(e.self_device_time_total for e in hits) / 1e3 / n
        log("profile", f"{what}: kernels matching {list(watch)} "
            f"{ms:.4f} ms/call = {100 * ms * n / busy_ms:.2f}% of device "
            f"time, {sum(e.count for e in hits) // n} launches/call | {card}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        ms = e.self_device_time_total / 1e3 / n
        log("profile", f"{ms:8.4f} ms/call {100 * ms * n / busy_ms:5.1f}% "
            f"x{e.count // n:<3d} {e.key[:100]}")


def profile_eval(model, x, card):
    import torch

    from dasemanticsegmentationaml_tpu_torch.train.evaluate import predict

    def run_one():
        with torch.inference_mode():
            predict(model, x, True, torch.bfloat16)

    profile_steps(run_one, "features + kernel, bf16, batch 8 (eval)", card,
                  watch=ARGMAX_KERNELS)


def time_argmax(device, card, fns=None):
    """Two versions of upsample_argmax, A and B (``fns``, in that order;
    by default the plain version and the kernel), at ``ARGMAX_TIMED`` in
    bf16 and fp32, in turns A B B A: by the chain (``cuda_ms``: the
    wrapper's host path included) and by device time alone
    (``device_ms``: the kernel's profiler sums; every kernel of the plain
    version). Returns, per (shape, dtype), the means by name and by
    (name, "device")."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua

    fns = fns or {"plain": ua.upsample_argmax_reference,
                  "kernel": ua.upsample_argmax}
    a, b = fns
    times = {}
    for shape, out_hw in ARGMAX_TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            x = logits_on(device, shape, 0, "normal", dtype)
            res = {}
            for name in (a, b, b, a):
                plain = name == "plain"
                call = functools.partial(fns[name], x, out_hw)
                res.setdefault(name, []).append(
                    cuda_ms(call, 10 if plain else 100))
                ms, _ = device_ms(call, None if plain else ARGMAX_KERNELS,
                                  n=5 if plain else 20)
                res.setdefault((name, "device"), []).append(ms)
            mean = {k: sum(v) / len(v) for k, v in res.items()}
            tag = str(dtype).replace("torch.", "")
            times[(shape, tag)] = mean
            bound = bound_upsample_argmax(shape, out_hw, x.element_size())
            log("timing", f"upsample_argmax {shape}->{out_hw} {tag}, turns "
                f"{a} {b} {b} {a}: " + "; ".join(
                    f"{name} device {mean[(name, 'device')]:.4f} ms "
                    f"{[round(t, 4) for t in res[(name, 'device')]]}, chain "
                    f"{mean[name]:.4f} ms {[round(t, 4) for t in res[name]]}"
                    for name in (a, b)) + f"; bound {bound[0]:.4f} ms "
                f"({bound[1]}), issue floor "
                f"{issue_floor_upsample_argmax(shape, out_hw):.4f} ms | {card}")
    return times


def time_eval(device, card, fns):
    """The eval forward (features + upsample_argmax, bf16 autocast, batch 8,
    512x1024, as ``train/evaluate.py::predict``) with each of two versions
    of upsample_argmax, A and B (``fns``, in that order), in turns A B B A;
    then a profiler pass of each: device busy share and the kernel's share
    of device time."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.data.pipeline import prepare_batch
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import build_bisenet

    model = build_bisenet(19, device=device,
                          generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(1)
    x, _ = prepare_batch(rng.integers(0, 256, (8, 512, 1024, 3),
                                      dtype=np.uint8),
                         np.zeros((8, 512, 1024), np.uint8), device=device,
                         dtype=torch.bfloat16)

    def forward(fn):
        with torch.inference_mode():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                feat = model.features(x)[0]
            fn(feat.contiguous(), x.shape[2:])

    a, b = fns
    runs = {}
    for name in (a, b, b, a):
        runs.setdefault(name, []).append(
            cuda_ms(lambda: forward(fns[name]), 20))
    for name, ms in runs.items():
        log("timing", f"eval forward (features + upsample_argmax {name}), "
            f"bf16, batch 8, 512x1024: mean {sum(ms) / len(ms):.3f} ms/batch "
            f"{[round(t, 3) for t in ms]} = "
            f"{8000.0 * len(ms) / sum(ms):.1f} images/s | {card}")
    for name in fns:
        profile_steps(lambda: forward(fns[name]),
                      f"eval forward with upsample_argmax {name}, bf16, "
                      f"batch 8", card, watch=ARGMAX_KERNELS)


def time_ce(device, card, fns=None):
    """Two versions of the CE function, A and B (``fns``, in that order; by
    default the plain version and the kernels), forward and backward apart,
    at the train step's head shapes, in turns A B B A: by the chain
    (``cuda_ms``: the wrapper's and autograd's host path included) and by
    device time alone (``device_ms``: the CE kernels' profiler sums; every
    kernel of the plain version). Returns, per (shape, dtype), the means by
    (part, name) for the chain and (part, name, "device")."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc

    fns = fns or {"plain": fc.cross_entropy_upsampled_reference,
                  "kernel": fc.cross_entropy_upsampled}
    a, b = fns
    times = {}
    for shape, out_hw in CE_MAIN_CASES[1:]:
        labels = ce_labels(device, (shape[0], *out_hw), 0, "mixed")
        for dtype in (torch.bfloat16, torch.float32):
            x = logits_on(device, shape, 0, "normal", dtype).requires_grad_()
            calls = {name: dict(zip(("fwd", "bwd"),
                                    ce_calls(fn, x, labels, out_hw)))
                     for name, fn in fns.items()}
            res, split = {}, {}
            for part in ("fwd", "bwd"):
                for name in (a, b, b, a):
                    plain = name == "plain"
                    call = calls[name][part]
                    res.setdefault((part, name), []).append(
                        cuda_ms(call, 10 if plain else 50))
                    ms, split[(part, name)] = device_ms(
                        call, None if plain else CE_KERNELS[part],
                        n=5 if plain else 20)
                    res.setdefault((part, name, "device"), []).append(ms)
            mean = {k: sum(v) / len(v) for k, v in res.items()}
            tag = str(dtype).replace("torch.", "")
            times[(shape, tag)] = mean
            for part in ("fwd", "bwd"):
                log("timing", f"fused CE {shape}->{out_hw} {tag} {part}, "
                    f"turns {a} {b} {b} {a}: " + "; ".join(
                        f"{name} device {mean[(part, name, 'device')]:.4f} ms "
                        f"{[round(t, 4) for t in res[(part, name, 'device')]]}"
                        + ("" if name == "plain" else " (" + ", ".join(
                            f"{k} {v:.4f}" for k, v in
                            split[(part, name)].items()) + ")")
                        + f", chain {mean[(part, name)]:.4f} ms "
                        f"{[round(t, 4) for t in res[(part, name)]]}"
                        for name in (a, b)) + f" | {card}")
    return times


def time_train_step(device, card, fns=None):
    """The bf16 train step at batch 8, 1024x512 with two versions of the CE
    function, A and B (``fns``, in that order; by default the kernels and
    the plain version), in turns A B B A; then a profiler pass of each
    version but the plain one."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.data.pipeline import prepare_batch
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        build_bisenet, trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc
    from dasemanticsegmentationaml_tpu_torch.train.optim import make_optimizer
    from dasemanticsegmentationaml_tpu_torch.train.supervised import (
        make_train_step)

    model = build_bisenet(19, device=device,
                          generator=torch.Generator().manual_seed(0)).train()
    opt = make_optimizer("sgd", trainable_parameters(model), 0.01,
                         momentum=0.9, weight_decay=1e-4)
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (8, 1024, 512, 3), dtype=np.uint8)
    labels = np.where(rng.random((8, 1024, 512)) < 0.05, 255,
                      rng.integers(0, 19, (8, 1024, 512))).astype(np.uint8)
    x, y = prepare_batch(images, labels, device=device, dtype=torch.bfloat16)
    fns = fns or {"kernel": fc.cross_entropy_upsampled,
                  "plain": fc.cross_entropy_upsampled_reference}
    steps = {name: make_train_step(model, opt, amp_dtype=torch.bfloat16,
                                   ce=ce)
             for name, ce in fns.items()}
    a, b = fns
    runs = {}
    for name in (a, b, b, a):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ms = cuda_ms(lambda: steps[name](x, y), 10, warmup=2)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        runs.setdefault(name, []).append((ms, peak))
        log("timing", f"train step, bf16, batch 8, 1024x512, CE {name}: "
            f"{ms:.3f} ms/step = {8000.0 / ms:.1f} images/s, peak memory "
            f"{peak:.2f} GiB | {card}")
    summary = {}
    for name, rs in runs.items():
        ms = sum(r[0] for r in rs) / len(rs)
        summary[name] = (ms, max(r[1] for r in rs))
        log("timing", f"train step, bf16, batch 8, CE {name}: mean "
            f"{ms:.3f} ms/step = {8000.0 / ms:.1f} images/s, peak memory "
            f"{summary[name][1]:.2f} GiB | {card}")
    for name in fns:
        if name != "plain":
            profile_steps(lambda: steps[name](x, y),
                          f"train step with the CE {name}, bf16, batch 8",
                          card, watch=CE_KERNELS["fwd"] + CE_KERNELS["bwd"])
    return summary


def interp_pass(shape, out_hw):
    """Elements of the cheaper first pass of a separable align_corners
    upsample of (B, C, h, w) to ``out_hw``: rows interpolated at (B, C, h,
    W), or columns at (B, C, H, w). PyTorch's formula h0 * (w0 * a + w1 *
    b) + h1 * (w0 * c + w1 * d) gives the same bits either way."""
    b, c, h, w = shape
    return b * c * min(h * out_hw[1], out_hw[0] * w)


def bound_upsample_argmax(shape, out_hw, elem):
    """Bound of one upsample_argmax call: it reads the (B, C, h, w) logits
    of ``elem`` bytes and six tap arrays and writes the (B, H, W) int32
    labels. What the function needs: the first pass of the interpolation
    (2 multiplies and an add per element, ``interp_pass``), then per output
    pixel and class the second pass (3) and a compare (fp32)."""
    b, c, h, w = shape
    px = b * out_hw[0] * out_hw[1]
    nbytes = b * c * h * w * elem + 12 * sum(out_hw) + 4 * px
    return roofline(nbytes, {"fp32": 3 * interp_pass(shape, out_hw)
                             + 4 * c * px})


def issue_floor_upsample_argmax(shape, out_hw):
    """The least time the card could issue csrc/upsample_argmax.cu's
    instructions in, beside ``bound_upsample_argmax``: per output pixel
    and class the column pass (3) and the running argmax's compare and two
    selects (3); per column segment of an output row and class 4 loads,
    the row pass (3 a column, 6) and the finiteness test (2). None is an
    FMA, so they issue at one a lane and clock: half the fp32 peak's rate,
    which counts an FMA as two operations."""
    b, c, h, w = shape
    px = b * out_hw[0] * out_hw[1]
    segments = b * out_hw[0] * min(w, out_hw[1])
    lane_instructions = 6 * c * px + 12 * c * segments
    return lane_instructions / (PEAK_OPS_PER_S["fp32"] / 2) * 1e3


def bound_ce(shape, out_hw, elem, n_valid, backward):
    """Bound of one fused CE call on ``n_valid`` labelled pixels (the
    others add nothing to the loss or the gradient). Both directions read
    the logits, the int32 labels and the taps; the forward writes the fp32
    loss, the backward the gradient in the logits' dtype. The first pass of
    the interpolation costs 3 per element (``interp_pass``); per valid pixel
    and class the second pass (3) and max, subtract, exp, add (4); per
    valid pixel log, pick, subtract and sum (5). The backward adds, per
    valid pixel and class, divide, one-hot, scale (3) and the second pass's
    adjoint (4), and the first pass's adjoint (4 per element) (fp32)."""
    b, c, h, w = shape
    logits = b * c * h * w * elem
    nbytes = (logits + 4 * b * out_hw[0] * out_hw[1] + 12 * sum(out_hw)
              + (logits if backward else 4))
    first = interp_pass(shape, out_hw)
    ops = 3 * first + n_valid * (7 * c + 5)
    if backward:
        ops += n_valid * c * 7 + 4 * first
    return roofline(nbytes, {"fp32": ops})


def bound_cat(stride, in_chw, chans, batch, elem):
    """Bound of one fused CatBottleneck launch: it reads the input, the
    folded weights (in ``elem`` bytes) and fp32 biases and writes the
    concat; the 1x1 and 3x3 convs are matrix products (tensor cores, 2 per
    multiply-add), while the stride-2 depthwise conv and average pool and
    every bias and ReLU are fp32."""
    cin, h, w = in_chw
    h1, h2, h3, h4 = chans
    out_px = batch * -(-h // stride) * -(-w // stride)
    in_px = batch * h * w
    weights = cin * h1 + 9 * (h1 * h2 + h2 * h3 + h3 * h4)
    vector = 2 * (in_px * h1 + out_px * (h2 + h3 + h4))
    if stride == 2:
        weights += 9 * h1
        vector += out_px * h1 * (18 + 10 + 1)
    nbytes = ((in_px * cin + out_px * sum(chans) + weights) * elem
              + 4 * (sum(chans) + (h1 if stride == 2 else 0)))
    macs = cat_macs(stride, in_chw, chans, batch)
    return roofline(nbytes, {"bf16_tensor": 2 * macs, "fp32": vector})


def stdc_phase_ms(fs, x, fp):
    """Device ms of each phase of one bf16 CatBottleneck launch (the entry
    conv; at stride 2 avd_pool; x2, x3, x4), by profiler kernel sums of
    launches whose later phases have no items (each phase's time is the
    difference from the launch with one phase fewer). The launches go to
    the library directly, past the wrapper's count: they measure, they are
    not the path."""
    import ctypes

    import torch

    from dasemanticsegmentationaml_tpu_torch.ops.cuda.build import (
        check_launch, current_stream)

    s = fp.stride
    plan = fs.launch_plan(x, fp)
    out_hw = (-(-x.shape[2] // s), -(-x.shape[3] // s))
    out = torch.empty((x.shape[0], sum(fp.channels), *out_hw),
                      dtype=x.dtype, device=x.device)
    mids = fs._tc_intermediates(x, plan, out_hw)
    n = 5 if s == 2 else 4

    def launch(upto):
        bar = torch.zeros(1, dtype=torch.int32, device=x.device)
        params = fs._tc_params(x, out, mids, bar, fp, plan)
        for k in range(upto + 1, n):
            if s == 2 and k == 1:
                params.dw_items = 0
            else:
                params.st[k - (1 if s == 2 else 0)].items = 0
        check_launch(fs._library().fused_cat_bf16(
            ctypes.byref(params), s, plan.grid, plan.smem,
            current_stream(x.device)), "fused_cat_bf16")

    upto = [device_ms(functools.partial(launch, k), STDC_KERNELS)[0]
            for k in range(n)]
    return [upto[0]] + [upto[k] - upto[k - 1] for k in range(1, n)]


def cat_macs(stride, in_chw, chans, batch):
    """Useful multiply-adds of one CatBottleneck's 1x1 and 3x3 convs."""
    cin, h, w = in_chw
    h1, h2, h3, h4 = chans
    out_px = batch * -(-h // stride) * -(-w // stride)
    return (batch * h * w * cin * h1
            + 9 * out_px * (h1 * h2 + h2 * h3 + h3 * h4))


def cat_macs_done(plan, batch):
    """Multiply-adds the bf16 body's plan does on the tensor cores: every
    item's tile (partial tiles whole), 64 output channels and its input
    channels padded to whole chunks, at every tap."""
    return sum(st.items(batch) * 32 * st.mt * 64 * st.nk * st.kc * st.taps
               for st in plan.stages)


def kernel_record(name, source, replaces, launches, max_err, ms, plain_ms,
                  bound, library_ms=None, **extra):
    """One kernel's entry of the kernels' JSON line."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms, **extra}


def compare_baseline(device, card, root):
    """``--baseline DIR``: the kernels of another version of the port (A,
    ``load_baseline``) against this checkout's (B) on this card, in one
    process. First the other upsample_argmax on ``kernel_cases`` (the
    cases it gets wrong are logged, not failed); then upsample_argmax by
    device and chain time in turns A B B A (``time_argmax``) and the eval
    forward with each (``time_eval``); then the CE kernels likewise
    (``time_ce``) and the bf16 train step with each (``time_train_step``)
    and its CE kernels' share of device time; then each of the six
    CatBottlenecks of features[2:8] and their six-launch chain
    (``time_stdc``: bf16, batch 8, device and chain time, beside the eager
    cuDNN modules)."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_stdc as fs
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua

    base_ua = load_baseline(root, "upsample_argmax")
    base_fc = load_baseline(root, "fused_ce")
    base_ua._library()
    base_fc._library()
    log("baseline", f"A = baseline, the package under {root}; B = kernel, "
        f"this checkout | {card}")
    n, bad, _, _ = kernel_cases(device, base_ua)
    log("baseline", f"the baseline's upsample_argmax differs from the plain "
        f"version on {len(bad)} of {n} cases" + "".join(
            f"\n  {case}" for case in bad))
    argmax = {"baseline": base_ua.upsample_argmax,
              "kernel": ua.upsample_argmax}
    time_argmax(device, card, argmax)
    time_eval(device, card, argmax)
    fns = {"baseline": base_fc.cross_entropy_upsampled,
           "kernel": fc.cross_entropy_upsampled}
    time_ce(device, card, fns)
    time_train_step(device, card, fns)
    base_fs = load_baseline(root, "fused_stdc")
    base_fs._library()
    backbone = seeded_backbone(device)
    h = stdc_input(device, backbone).to(torch.bfloat16)
    time_stdc(device, backbone, h, card, {
        "baseline": (base_fs.fold_cat_params, base_fs.fused_cat_bottleneck),
        "kernel": (fs.fold_cat_params, fs.fused_cat_bottleneck)})


def main(argv=None):
    import argparse
    import concurrent.futures as futures

    import torch

    parser = argparse.ArgumentParser(
        description="Drive the PyTorch port on one CUDA card, phase by phase.")
    parser.add_argument(
        "--baseline", metavar="DIR",
        help="instead of the phases, hold the upsample+argmax, CE and "
             "CatBottleneck kernels "
             "against those of the version of "
             "dasemanticsegmentationaml_tpu_torch/ under DIR")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import copy_probe as cp
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_stdc as fs
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import tile_roll as tr
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua
    from dasemanticsegmentationaml_tpu_torch.ops.cuda.build import BUILD_LOGS
    from dasemanticsegmentationaml_tpu_torch.tools import probe_copy

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log("device", f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()}"
        f" device(s); torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card, flush=True)

    t0 = time.perf_counter()
    libs = (ua, fc, fs, cp, tr)
    with futures.ThreadPoolExecutor(len(libs)) as pool:
        for job in [pool.submit(lib._library) for lib in libs]:
            job.result()
    sources = ("upsample_argmax", "fused_ce", "fused_stdc", "copy_probe",
               "tile_roll")
    log("build", f"{', '.join(f'{n}.cu' for n in sources)} built (in "
        f"parallel) and loaded in {time.perf_counter() - t0:.2f} s (set-up)")
    for name in sources:
        for line in BUILD_LOGS.get(name, "").splitlines():
            log("build", f"{name}: {line}")
    if args.baseline:
        compare_baseline(device, card, args.baseline)
        log("done", f"baseline compared in {time.perf_counter() - t_start:.1f}"
            f" s | {card}")
        return 0

    max_err = phase_kernel(device)
    ce_errs = phase_ce_kernel(device)
    stdc_errs = phase_stdc_kernel(device)
    (copy_launches, copy_times, copy_others, copy_bound, copy_err,
     copy_turns) = phase_copy_probe(device, card)
    roll_launches, roll_times, roll_bound, roll_err = phase_roll_kernel(
        device, card)
    backbone = seeded_backbone(device)
    stdc_launches, h = phase_stdc_path(device, backbone)
    model = phase_model(device)
    eval_launches = phase_slice()
    train_launches = phase_train()
    phase_train_parity(device)
    phase_da()
    phase_da_parity(device)
    times = phase_timing(device, model, card)
    stdc_times = time_stdc(device, backbone, h, card)
    time_da_step(device, card)

    argmax = times["argmax"][((2, 19, 128, 64), "bfloat16")]
    ce_shape, ce_hw = CE_MAIN_CASES[0]
    ce = times["ce"][(ce_shape, "bfloat16")]
    labels = ce_labels("cpu", (ce_shape[0], *ce_hw), 0, "mixed")
    n_valid = int(((labels >= 0) & (labels < ce_shape[1])).sum())
    # a fused_cat kernel's times and bound: sums over the three bottlenecks
    # of its stride on the path, bf16, batch 8
    stdc_keys = {"ms": "kernel", "plain_ms": "plain",
                 "device_ms": ("kernel", "device"),
                 "plain_device_ms": ("plain", "device"), "eager_ms": "eager",
                 "eager_device_ms": ("eager", "device")}
    stdc_ms = {s: {k: sum(stdc_times[(f"features[{i + 2}]", "bfloat16")][v]
                          for i, (st, _, _) in enumerate(STDC813_BOTTLENECKS)
                          if st == s) for k, v in stdc_keys.items()}
               for s in (1, 2)}
    stdc_bound = {}
    for s in (1, 2):
        parts = [bound_cat(st, chw, chans, 8, 2)
                 for st, chw, chans in STDC813_BOTTLENECKS if st == s]
        stdc_bound[s] = (sum(p[0] for p in parts), max(parts)[1])
    copy_ms = {"copy_block": copy_times["copy_block"]["chain"],
               "copy_direct": copy_times[probe_copy.direct_label()]["chain"],
               "copy_bounce": copy_times[probe_copy.bounce_label(
                   BOUNCE_SLOTS)]["chain"]}
    copy_extra = {
        "copy_block": {},
        "copy_direct": {"tiles_per_block": cp.DIRECT_TILES_PER_BLOCK},
        "copy_bounce": {"n_slots": BOUNCE_SLOTS,
                        **cp.BOUNCE_DEFAULTS[BOUNCE_SLOTS]._asdict()}}
    log("done", f"every phase passed in {time.perf_counter() - t_start:.1f} s"
        f" | {card}")
    print(json.dumps({"kernels": [
        kernel_record("upsample_argmax", KERNEL_SOURCE, KERNEL_REPLACES,
                      eval_launches, max_err, argmax["kernel"],
                      argmax["plain"],
                      bound_upsample_argmax((2, 19, 128, 64), (1024, 512), 2),
                      device_ms=argmax[("kernel", "device")],
                      plain_device_ms=argmax[("plain", "device")])
        ] + [
        kernel_record(f"fused_ce_{part}", CE_SOURCE, CE_REPLACES,
                      train_launches[f"fused_ce_{part}"],
                      ce_errs["loss" if part == "fwd" else "grad"],
                      ce[(part, "kernel")], ce[(part, "plain")],
                      bound_ce(ce_shape, ce_hw, 2, n_valid, part == "bwd"),
                      device_ms=ce[(part, "kernel", "device")],
                      plain_device_ms=ce[(part, "plain", "device")])
        for part in ("fwd", "bwd")] + [
        kernel_record(f"fused_cat_s{s}", STDC_SOURCE, STDC_REPLACES[s],
                      stdc_launches[f"fused_cat_s{s}"], stdc_errs[s],
                      stdc_ms[s].pop("ms"), stdc_ms[s].pop("plain_ms"),
                      stdc_bound[s], **stdc_ms[s])
        for s in (1, 2)] + [
        kernel_record(name, COPY_SOURCE, COPY_REPLACES[name],
                      copy_launches[name], copy_err, copy_ms[name],
                      copy_others["plain x.clone()"], copy_bound,
                      copy_others["library copy_"], **copy_turns[name],
                      **copy_extra[name])
        for name in ("copy_block", "copy_direct", "copy_bounce")] + [
        kernel_record("tile_roll", ROLL_SOURCE, ROLL_REPLACES, roll_launches,
                      roll_err, roll_times["kernel"], roll_times["plain"],
                      roll_bound, roll_times["library"],
                      shape=[16384, 8192], dtype="bfloat16")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
