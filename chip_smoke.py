#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, phase by phase.

    python3 chip_smoke.py

1. device      -- a CUDA card must be present (exit 1 otherwise, no CPU
                  fallback); prints its name and power limit from nvidia-smi.
2. build       -- compiles csrc/upsample_argmax.cu, csrc/fused_ce.cu and
                  csrc/fused_stdc.cu with nvcc for sm_90a, one nvcc each, all
                  at once; prints ptxas.
3. kernel      -- the fused upsample+argmax kernel against its plain PyTorch
                  version on the card, bit for bit, on random-normal and
                  tie-heavy logits in fp32 and bf16, at the main path's shapes
                  and at odd, identity and one-pixel edge shapes.
4. ce-kernel   -- the fused upsample+CE forward and backward kernels against
                  their plain version (loss, gradient) in fp32 and bf16, at
                  the train step's three head shapes and at edge shapes, with
                  ignored, out-of-range and all-ignored labels; two runs
                  bit-identical.
5. stdc-kernel -- the fused CatBottleneck kernels (fused_cat_s1 / _s2)
                  against their plain PyTorch version on folded weights, at
                  the six STDC813 bottleneck shapes at batch 8, 1024x512 and
                  at edge shapes, in fp32 and bf16; two runs bit-identical.
6. stdc-path   -- the fused bottleneck's own path (not wired into any CLI,
                  as in the JAX package): a seeded STDCNet813 in eval mode,
                  its features[2:8] folded and run as six fused launches in
                  bf16 at batch 8, 1024x512 (the counts reset before and read
                  after), against the eager modules in fp32.
7. model       -- full-width BiSeNet-STDC813 (seeded weights) at 2x3x512x1024:
                  fp32 features on the card against the same module on the CPU
                  (TF32 off), and bf16 autocast predictions against fp32.
8. slice       -- the port's --domain_shift CLI on a synthetic 4-image
                  Cityscapes val tree at 1024x512 on cuda:0 in bf16 (the
                  kernel's launch count is reset before and read after), then
                  fp32 on the card against fp32 on the CPU.
9. train       -- the port's supervised CLI on a synthetic 16 + 4 image tree
                  at 1024x512, batch 8, bf16, 2 epochs of 2 steps (the
                  kernels' counts reset before and read after); its best.pth
                  through the --domain_shift CLI reproduces its mIoU.
10. train-parity- one fp32 train step at 2x3x1024x512 on the card against
                  the same step on the CPU (TF32 off) and in fp64 on the CPU.
11. da        -- the port's DA CLI (GTA5 -> Cityscapes) on synthetic 16 +
                  16 + 4 image trees at 1024x512, batch 8, bf16, 2 epochs of
                  2 steps, once with the FC discriminator and the 4-phase
                  step, once with the DW+BN one and the combined step (the CE
                  kernels' counts reset before and read after each); its
                  GTA5_1.pth through the --domain_shift CLI.
12. da-parity  -- one fp32 DA step (DW+BN discriminator) at 2x3x1024x512 on
                  the card against the same step on the CPU (TF32 off) and in
                  fp64 on the CPU.
13. timing     -- CUDA-event times of every kernel and of its plain version,
                  features + argmax kernel throughput, the bf16 train step at
                  batch 8 with the CE kernel and with its plain version (turns
                  A B B A, peak memory), the bf16 DA step at batch 8, the
                  features[2:8] chain eager (cuDNN) against fused, and
                  torch.profiler passes: device busy share and top kernels.

Every failure raises and ends the run with a non-zero exit. The line
before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import copy
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


def logits_on(device, shape, seed, tie_heavy, dtype):
    import torch

    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if tie_heavy:  # small integers: exact ties between classes are common
        x = np.round(x * 4).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def phase_kernel(device):
    import torch

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua

    cases = [  # (logits shape, output size)
        ((2, 19, 64, 128), (512, 1024)),   # 512x1024 input
        ((2, 19, 128, 64), (1024, 512)),   # the CLI's faithful-resize shape
        ((1, 19, 7, 13), (37, 50)),        # odd sizes, no multiple of 8
        ((2, 19, 64, 128), (64, 128)),     # identity
        ((1, 19, 1, 13), (37, 50)),        # h = 1
        ((1, 19, 1, 1), (3, 5)),           # one source pixel
        ((3, 19, 5, 9), (1, 1)),           # one output pixel
    ]
    before = ua.LAUNCHES
    max_err = 0.0
    n = 0
    for shape, out_hw in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for tie_heavy in (False, True):
                x = logits_on(device, shape, n, tie_heavy, dtype)
                got = ua.upsample_argmax(x, out_hw)
                want = ua.upsample_argmax_reference(x, out_hw)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                max_err = max(max_err, float(err))
                mism = (got != want).float().mean().item()
                check(got.shape == (shape[0], *out_hw)
                      and got.dtype == torch.int32, f"bad output {got.shape}")
                check(torch.equal(got, want),
                      f"kernel != plain at {shape}->{out_hw} {dtype} "
                      f"tie_heavy={tie_heavy}: mismatch {mism}")
                n += 1
    check(ua.LAUNCHES - before == n,
          f"LAUNCHES rose by {ua.LAUNCHES - before}, expected {n}")
    log("kernel", f"{n} cases bit-identical to the plain version "
        f"(fp32+bf16, random-normal+tie-heavy); max |kernel-plain| = "
        f"{max_err}; LAUNCHES +{n}")
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
    ]
    fwd0, bwd0 = fc.FWD_LAUNCHES, fc.BWD_LAUNCHES
    calls = 0
    errs = {"loss": 0.0, "grad": 0.0}
    for n, (shape, out_hw, mode) in enumerate(cases):
        labels = ce_labels(device, (shape[0], *out_hw), n, mode)
        for dtype in (torch.float32, torch.bfloat16):
            x = logits_on(device, shape, n, False, dtype)
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
    2, H = 2 at stride 2, and a width below one tile."""
    cases = [(f"features[{i + 2}]", s, (8, *chw), chans)
             for i, (s, chw, chans) in enumerate(STDC813_BOTTLENECKS)]
    b2, b3, b4, b5 = (STDC813_BOTTLENECKS[i][2] for i in range(4))
    cases += [("odd s1", 1, (2, 256, 19, 37), b3),
              ("odd s2", 2, (1, 256, 13, 7), b4),
              ("H=2 s2", 2, (1, 64, 2, 30), b2),
              ("W=3 s1", 1, (2, 512, 9, 3), b5)]
    return cases


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
            p = fs.plan(stride, x.element_size(), shape[1], chans, shape[0],
                        tuple(got.shape[2:]))
            log("stdc-kernel", f"{name} s{stride} {shape} {tag}: tile "
                f"{p.th}x{p.tw} chunk {p.chunk} smem {p.smem} B; max|kernel-"
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

    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (8, 3, 512, 1024)).astype(np.float32)).to(device)
    with torch.inference_mode():
        with fp32_math():
            x1 = backbone.features[1](backbone.features[0](x))
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
    return launches, folded, h


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


def time_stdc(device, backbone, folded, h, card):
    """Each bottleneck, kernel against its plain version, in bf16 and fp32
    (the plain version with TF32 off, as it is checked); then the
    features[2:8] chain at bf16, batch 8: eager cuDNN modules in eval mode
    under autocast against the six fused launches. Turns A B B A."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_stdc as fs

    times = {}
    for n, (name, stride, shape, chans) in enumerate(stdc_cases()[:6]):
        block = backbone.features[n + 2]
        x32 = torch.from_numpy(np.random.default_rng(n).standard_normal(
            shape).astype(np.float32)).to(device)
        for dtype in (torch.bfloat16, torch.float32):
            fp = fs.fold_cat_params(block, dtype)
            x = x32.to(dtype)
            res = {}
            with torch.inference_mode(), fp32_math():
                for which in ("plain", "kernel", "kernel", "plain"):
                    fn = (fs.fused_cat_bottleneck if which == "kernel"
                          else fs.fused_cat_bottleneck_plain)
                    res.setdefault(which, []).append(
                        cuda_ms(lambda: fn(x, fp), 10))
            mean = {k: sum(v) / len(v) for k, v in res.items()}
            tag = str(dtype).replace("torch.", "")
            times[(name, tag)] = (mean["kernel"], mean["plain"])
            log("timing", f"fused CatBottleneck {name} s{stride} {shape} {tag}"
                f": kernel {mean['kernel']:.4f} ms {res['kernel']}, plain "
                f"{mean['plain']:.4f} ms {res['plain']} | {card}")

    def eager():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            backbone.features[2:8](h)

    def fused():
        out = h
        for fp in folded:
            out = fs.fused_cat_bottleneck(out, fp)

    res = {}
    with torch.inference_mode():
        for which in ("eager", "fused", "fused", "eager"):
            res.setdefault(which, []).append(
                cuda_ms(eager if which == "eager" else fused, 10))
    mean = {k: sum(v) / len(v) for k, v in res.items()}
    times["chain"] = mean
    log("timing", f"features[2:8], bf16, batch 8, 1024x512: eager cuDNN "
        f"(autocast, eval) {mean['eager']:.4f} ms {res['eager']}; six fused "
        f"launches {mean['fused']:.4f} ms {res['fused']}; fused / eager "
        f"{mean['fused'] / mean['eager']:.2f} | {card}")
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
                  "DA step, bf16, batch 8, FC D, interleaved", card)
    return ms, peak


def phase_timing(device, model, card):
    import torch

    from dasemanticsegmentationaml_tpu_torch.data.pipeline import prepare_batch
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua
    from dasemanticsegmentationaml_tpu_torch.train.evaluate import predict

    times = {}
    for shape, out_hw in (((2, 19, 128, 64), (1024, 512)),
                          ((2, 19, 64, 128), (512, 1024)),
                          ((8, 19, 64, 128), (512, 1024))):
        for dtype in (torch.bfloat16, torch.float32):
            x = logits_on(device, shape, 0, False, dtype)
            plain_a = cuda_ms(lambda: ua.upsample_argmax_reference(x, out_hw), 10)
            kern_a = cuda_ms(lambda: ua.upsample_argmax(x, out_hw), 100)
            kern_b = cuda_ms(lambda: ua.upsample_argmax(x, out_hw), 100)
            plain_b = cuda_ms(lambda: ua.upsample_argmax_reference(x, out_hw), 10)
            kern, plain = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
            name = str(dtype).replace("torch.", "")
            times[(shape, name)] = (kern, plain)
            out_mb = shape[0] * out_hw[0] * out_hw[1] * 4 / 1e6
            log("timing", f"upsample_argmax {shape}->{out_hw} {name}: kernel "
                f"{kern:.4f} ms ({kern_a:.4f}, {kern_b:.4f}), plain "
                f"{plain:.4f} ms ({plain_a:.4f}, {plain_b:.4f}); "
                f"{out_mb / kern:.1f} GB/s of int32 output | {card}")

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


def profile_steps(run_one, what, card, n=10):
    """Where the time of ``run_one`` goes: device busy share, kernels per
    call, host enqueue time, and the heaviest kernels (torch.profiler)."""
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

    profile_steps(run_one, "features + kernel, bf16, batch 8 (eval)", card)


def time_ce(device, card):
    """The fused CE kernels against the plain version, forward and
    backward apart, at the train step's head shapes; turns A B B A."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc

    times = {}
    fns = {"kernel": fc.cross_entropy_upsampled,
           "plain": fc.cross_entropy_upsampled_reference}
    for shape, out_hw in CE_MAIN_CASES[1:]:
        labels = ce_labels(device, (shape[0], *out_hw), 0, "mixed")
        for dtype in (torch.bfloat16, torch.float32):
            x = logits_on(device, shape, 0, False, dtype).requires_grad_()
            res = {}
            for part in ("fwd", "bwd"):
                for name in ("plain", "kernel", "kernel", "plain"):
                    fn = fns[name]
                    if part == "fwd":
                        def call(fn=fn):
                            with torch.no_grad():
                                fn(x, labels, out_hw)
                    else:
                        loss = fn(x, labels, out_hw)

                        def call(loss=loss):
                            torch.autograd.grad(loss, x, retain_graph=True)
                    iters = 50 if name == "kernel" else 10
                    res.setdefault((part, name), []).append(
                        cuda_ms(call, iters))
            mean = {k: sum(v) / len(v) for k, v in res.items()}
            tag = str(dtype).replace("torch.", "")
            times[(shape, tag)] = mean
            log("timing", f"fused CE {shape}->{out_hw} {tag}: forward "
                f"kernel {mean[('fwd', 'kernel')]:.4f} ms "
                f"{res[('fwd', 'kernel')]}, plain {mean[('fwd', 'plain')]:.4f}"
                f" ms {res[('fwd', 'plain')]}; backward kernel "
                f"{mean[('bwd', 'kernel')]:.4f} ms {res[('bwd', 'kernel')]}, "
                f"plain {mean[('bwd', 'plain')]:.4f} ms "
                f"{res[('bwd', 'plain')]} | {card}")
    return times


def time_train_step(device, card):
    """The bf16 train step at batch 8, 1024x512 with the fused CE kernel
    and with its plain version, in turns A B B A; then a profiler pass."""
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
    steps = {name: make_train_step(model, opt, amp_dtype=torch.bfloat16,
                                   ce=ce)
             for name, ce in (("kernel", fc.cross_entropy_upsampled),
                              ("plain", fc.cross_entropy_upsampled_reference))}
    runs = {}
    for name in ("kernel", "plain", "plain", "kernel"):
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
    profile_steps(lambda: steps["kernel"](x, y),
                  "train step with the CE kernel, bf16, batch 8", card)
    return summary


def main():
    import concurrent.futures as futures

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_stdc as fs
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua
    from dasemanticsegmentationaml_tpu_torch.ops.cuda.build import BUILD_LOGS

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log("device", f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()}"
        f" device(s); torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card, flush=True)

    t0 = time.perf_counter()
    with futures.ThreadPoolExecutor(3) as pool:
        for job in [pool.submit(lib._library) for lib in (ua, fc, fs)]:
            job.result()
    log("build", f"upsample_argmax.cu, fused_ce.cu and fused_stdc.cu built "
        f"(in parallel) and loaded in {time.perf_counter() - t0:.2f} s "
        f"(set-up)")
    for name in ("upsample_argmax", "fused_ce", "fused_stdc"):
        for line in BUILD_LOGS.get(name, "").splitlines():
            log("build", f"{name}: {line}")

    max_err = phase_kernel(device)
    ce_errs = phase_ce_kernel(device)
    stdc_errs = phase_stdc_kernel(device)
    backbone = seeded_backbone(device)
    stdc_launches, folded, h = phase_stdc_path(device, backbone)
    model = phase_model(device)
    eval_launches = phase_slice()
    train_launches = phase_train()
    phase_train_parity(device)
    phase_da()
    phase_da_parity(device)
    times = phase_timing(device, model, card)
    stdc_times = time_stdc(device, backbone, folded, h, card)
    time_da_step(device, card)

    kern, plain = times[((2, 19, 128, 64), "bfloat16")]
    ce = times["ce"][(CE_MAIN_CASES[0][0], "bfloat16")]
    # a fused_cat kernel's ms / plain_ms: the sum over the three bottlenecks
    # of its stride on the path, bf16, batch 8
    stdc_ms = {s: [sum(stdc_times[(f"features[{i + 2}]", "bfloat16")][k]
                       for i, (st, _, _) in enumerate(STDC813_BOTTLENECKS)
                       if st == s) for k in (0, 1)] for s in (1, 2)}
    log("done", f"every phase passed in {time.perf_counter() - t_start:.1f} s"
        f" | {card}")
    print(json.dumps({"kernels": [
        {"name": "upsample_argmax", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES, "launches": eval_launches,
         "max_abs_err": max_err, "ms": kern, "plain_ms": plain},
        {"name": "fused_ce_fwd", "route": "cuda", "source": CE_SOURCE,
         "replaces": CE_REPLACES, "launches": train_launches["fused_ce_fwd"],
         "max_abs_err": ce_errs["loss"], "ms": ce[("fwd", "kernel")],
         "plain_ms": ce[("fwd", "plain")]},
        {"name": "fused_ce_bwd", "route": "cuda", "source": CE_SOURCE,
         "replaces": CE_REPLACES, "launches": train_launches["fused_ce_bwd"],
         "max_abs_err": ce_errs["grad"], "ms": ce[("bwd", "kernel")],
         "plain_ms": ce[("bwd", "plain")]}] + [
        {"name": f"fused_cat_s{s}", "route": "cuda", "source": STDC_SOURCE,
         "replaces": STDC_REPLACES[s],
         "launches": stdc_launches[f"fused_cat_s{s}"],
         "max_abs_err": stdc_errs[s], "ms": stdc_ms[s][0],
         "plain_ms": stdc_ms[s][1]} for s in (1, 2)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
