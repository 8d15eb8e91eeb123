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
features[2:8] chain with it timed in turns A B B A, and last the
unaugmented train and DA steps, each with its own package's batch
preparation, in turns A B B A, then the earlier int8 conv beside this
checkout's at the 24 shapes of the --quantize_filter all blocks (device
ms, bit for bit, the sum over a batch's 35 launches), the host's
microseconds a call of the earlier wrappers, of this checkout's and of
its custom ops through the dispatcher (``time_dispatch``), and last the
earlier version's eager eval loop and its own int8 models (head_ch and
all), eager and windowed by 8, against this checkout's (the eval-window
phase with the baseline's passes first and last: eager against eager
is the cost of calling the kernels through their custom ops); nothing
else runs (``compare_baseline``).

1. device      -- a CUDA card must be present (exit 1 otherwise, no CPU
                  fallback); prints its name and power limit from nvidia-smi.
2. build       -- compiles csrc/upsample_argmax.cu, csrc/fused_ce.cu,
                  csrc/fused_stdc.cu, csrc/copy_probe.cu, csrc/tile_roll.cu
                  and csrc/int8_conv.cu with nvcc for sm_90a, one nvcc each,
                  and native/augment.cpp (the host augmentation) and
                  native/loader.cpp (the decoder) with g++, all at once; prints ptxas, and whether
                  png.h and jpeglib.h are on g++'s include path (with them
                  the decoder must build; without, decode runs on PIL).
3. kernel      -- the fused upsample+argmax kernel against its plain PyTorch
                  version on the card, bit for bit, on random-normal,
                  tie-heavy and non-finite (NaN, +-inf, an all-NaN pixel)
                  logits in fp32 and bf16, at the main path's shapes (B = 1
                  and 2) and at edge shapes (odd sizes, identity, h = 1, one
                  source or output pixel, downsampling, w = 1, C = 3, 32
                  and 40, a ragged last band); then its row windows (the
                  height-sharded eval's) against the full kernel's rows
                  and the windowed plain version, each launch
                  synchronised and named.
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
5b. int8-kernel - the int8 conv kernels (a prologue that quantizes the
                  input once into NHWC int8 or im2col rows, then the s8 x
                  s8 -> s32 implicit GEMM on wgmma with the fp32 epilogue)
                  against their plain version (a float64 convolution of the
                  int8 values), bit for bit, at BiSeNet's block shapes at
                  batch 8 and at edge shapes, in every pair of fp32 / bf16
                  input and output; then each of the 24 shapes of the 35
                  blocks of --quantize_filter all at batch 8, 512x1024, bit
                  for bit in bf16, its device ms (prologue and GEMM) beside
                  cuDNN's bf16 conv of that shape, the bound (and the bound
                  with the prologue's scratch) and the share, and the sum
                  over the 35 launches of a batch; then at conv_out.conv's
                  (8, 256, 64, 128) the kernels, the plain version, the
                  library yardstick (im2col + torch._int_mm + the
                  epilogue) and cuDNN's bf16 conv, in turns.
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
                  kernel's launch count is reset before and read after),
                  writing a --export_batches 1,8 bundle (--export_model)
                  whose metadata names the op; then fp32 on the card
                  against fp32 on the CPU.
10b. int8-slice - the slice's main path: the --domain_shift CLI with
                  --quantize_int8 True (filter all) and --eval_scan_window
                  2, bf16, on a 4-image 1024x512 tree (the counts reset
                  before and read after: both kernels, eager and by graph
                  replay); every --quantize_filter with both
                  --quantize_clip values (int8 launches = blocks x
                  batches; all with absmax also writes an --export_model
                  artifact holding both ops); head_ch in fp32 on the
                  card against the CPU.
11. train      -- the port's supervised CLI on a synthetic 16 + 4 image tree
                  at 1024x512, batch 8, bf16, 2 epochs of 2 steps, its
                  validations in --eval_scan_window 2 (the kernels' counts
                  reset before and read after; the final evaluation
                  replays the validation's capture); its best.pth through
                  the (eager) --domain_shift CLI reproduces its mIoU.
12. train-parity- one fp32 train step at 2x3x1024x512 on the card against
                  the same step on the CPU (TF32 off) and in fp64 on the CPU.
13. augment    -- the device augmentation (CS-HF, H-RP, B-GS-R) on the card
                  against the CPU with the same explicit parameters at batch
                  8, 1024x512: the training path within 1e-2 and labels
                  equal on >= 99.9% of the pixels, the pil-exact replay
                  bit for bit (H-RP: JAX's envelope); then its ms per
                  batch, labels warped or not, and the native host ops' ms
                  per image on one thread beside their numpy plain version.
14. da        -- the port's DA CLI (GTA5 -> Cityscapes) on synthetic 16 +
                  16 + 4 image trees at 1024x512, batch 8, bf16, 2 epochs:
                  with the FC discriminator and the 4-phase step, with the
                  DW+BN one and the combined step (2 steps an epoch), with
                  the source augmented by H-RP on the card and by B-GS-R on
                  the host with its labels warped (1 step an epoch); each
                  run's GTA5_1.pth through the --domain_shift CLI; then the
                  supervised CLI on the GTA5 tree with CS-HF on the card.
                  The kernels' counts are reset before and read after each
                  run.
15. da-parity  -- one fp32 DA step (DW+BN discriminator) at 2x3x1024x512 on
                  the card against the same step on the CPU (TF32 off) and in
                  fp64 on the CPU.
16. resume     -- the supervised CLI at batch 8, 1024x512, fp32, 3 steps an
                  epoch, through one --data_cache (the first run builds
                  it), with --iter_size 1 and 2: a straight 4-epoch run
                  that keeps its own epoch-2 state, a branch resumed from
                  it (epoch 3 again from the same state), and a run that
                  dies as epoch 3 starts, resumed with --resume
                  <save>/state (with 2 the saved state holds half an
                  accumulation). Every restored model, optimizer and
                  accumulator equals its file bit for bit; 3 + 3 CE
                  launches per mini-step in each run (counts reset before,
                  read after); the branch within loss rtol 1e-4 and 0.02 of
                  its epoch's update (global l2) of the straight run; the
                  died + resumed run's distance printed (the card's
                  backward sums in no fixed order, so two runs part from
                  the second step on); the state's save and restore timed,
                  its size printed.
17. da-resume  -- the DA CLI (FC D, fp32, batch 8, 1024x512, 2 steps an
                  epoch), the same four runs over 3 epochs with the death
                  as epoch 2 starts: GTA5_1 / latest and GTA5_1_D1 /
                  latest_D1 states and the marker 1 left, G, D and both
                  optimizers restored bit for bit, the branch's epoch
                  within loss_seg rtol 1e-3 and loss_D1 5e-3.
18. timing     -- CUDA-event times of every kernel and of its plain version
                  (the upsample+argmax, CE and CatBottleneck kernels and
                  their plain version also by their device time alone,
                  from the profiler's kernel sums; upsample+argmax beside
                  its bound and its issue floor; each CatBottleneck beside
                  the eager cuDNN module, with the device time of each
                  phase of its launch and the GMAC its plan does),
                  features + argmax kernel throughput, the bf16 train step at
                  batch 8 with the CE kernel and with its plain version (turns
                  A B B A, peak memory), the bf16 DA step at batch 8 (and
                  with its batches prepared, the source augmented by each
                  menu on the card against unaugmented, turns A B C D D C B
                  A), the features[2:8] chain eager (cuDNN) against fused,
                  and
                  torch.profiler passes: device busy share, top kernels and
                  the CE kernels' share of the train and DA steps.
18b. eval-window- eval images/s over 16 prepared bf16 batches of 8 at
                  512x1024: eager against --eval_scan_window 8 and 4 (turns
                  A B C C B A), and the int8 models of head_ch and all
                  (their calibration timed) eager against window 8; counts
                  equal to eager's; device busy share of each.
19. loader     -- the card's host: os.cpu_count(); 16 Cityscapes-sized
                  pairs (2048x1024 PNG image + label) and 4 JPEGs decoded to
                  1024x512 by the native decoder and by PIL, bit for bit;
                  ms per pair on one thread; the Loader's images/s at batch
                  8 with 1, 4 and 8 workers, native and PIL; the
                  --data_cache build and warm read; beside the train step's
                  ms per image.
20. serve      -- the serving path at 512x1024, seeded weights, bf16 and
                  int8 all: a symbolic-batch artifact and a 1,8 bundle
                  exported (utils/export.py; seconds, bytes, the ops in
                  the saved graph); loaded, its labels against predict at
                  batch 1, 3 and 8 and the bundle's programs at theirs,
                  serve.Program's CUDA-graph replay against the eager
                  call, bit for bit, each batch synchronised and named;
                  launches through the artifact (1 upsample_argmax a
                  batch, 35 int8_conv calls an int8 batch), eager and
                  replayed, and in a fresh process replayed under the
                  profiler, held equal to the kernels it saw; the
                  artifact alone, eager against replayed, on 16 device
                  uint8 batches of 8 (images/s in turns A B B A, busy
                  share, kernel ms a batch, peak memory); then python -m
                  ...serve --batch_size 8 --color in a fresh process on
                  19 2048x1024 PNGs (the bf16 artifact, the int8 bundle):
                  output names, no module of models/ imported (-X
                  importtime), labels against predict on the same decoded
                  frames, batched alike, >= 99.9%, colours the palette's;
                  first-batch seconds, steady images/s, decode ms. It runs
                  after the timing phases: placed before them, a profile
                  there once recorded no kernel at all.

21. parallel   -- data parallelism across ranks (parallel/), after the
                  profiled phases (its parent profiles nothing): two gloo
                  ranks share cuda:0 (NCCL refuses two ranks on one card),
                  each on 4 rows of a global batch of 8 at 1024x512, fp32,
                  TF32 off: one sharded train step with --sync_bn True and
                  False and one DA step (sync: DW+BN D; per replica: FC D),
                  each held against one process on the card (the plain
                  step on the global batch; per replica, a model copy a
                  half with its gradients averaged), each rank's CE
                  launches by its counters and its profile (3 + 3 a train
                  step, 2 + 2 a DA step), the ranks' parameters equal;
                  sharded eval: two ranks' int64 counts over 8 + 8 of 16
                  prepared bf16 batches equal one process's over all 16;
                  then at world 1 over NCCL a sync-BN train step against
                  the step without a group, allreduce_counts, and the
                  port's sync BN timed against nn.BatchNorm2d,
                  torch.nn.SyncBatchNorm and the library's sync function;
                  the step ms of each mode beside the card.
22. spatial    -- the height-sharded mesh (parallel/spatial.py), last: two
                  gloo ranks share cuda:0 as data 1 x spatial 2, each on
                  512 of the 1024 rows of a global batch of 4, fp32, TF32
                  off: the sync train step and the DA step with the DW+BN
                  and with the FC D against one process on the card, the
                  ranks' parameters equal, 3 + 3 and 2 + 2 CE launches a
                  rank by counters and profile; on each band the windowed
                  upsample_argmax against the full kernel's rows (fp32,
                  bf16) and the windowed CE kernels against their plain
                  version, the shares' sum against the full kernel; 16
                  bf16 eval batches of 8 (and 4 in fp32) in two bands
                  against one process, 1 upsample_argmax a rank a batch;
                  step ms, halo exchanges and peak memory a rank. The
                  kernel phase runs the row windows too (first, middle
                  and last bands, taps past both edges).
23. mesh-serve -- int8 eval on the height-sharded mesh and the
                  multi-device serving artifacts, last, at 512x1024 with
                  seeded weights (its int8 kernel with pad_h = 0 on each
                  of two bands of conv_out.conv's (8, 256, 64, 128) and of
                  the stem's (8, 3, 512, 1024), bf16, bit for bit against
                  its plain version and the whole kernel's rows, device ms
                  beside the whole conv's, runs right after the int8-kernel
                  phase: late in a long process the profiler loses kernel
                  records); two gloo ranks share cuda:0: 16 bf16 eval batches of 8 through the int8
                  `all` model in two bands (calibrated whole) against one
                  process's int8 eval (mIoU |Δ| <= 1e-3, labels held to
                  one process's own agreement with each batch as two of 4
                  less SPATIAL_BF16_SLACK; peak memory a rank against one
                  process); the batch-sharded artifacts (bf16, int8 `all`)
                  a rank at batch 8, replayed and eager, bit for bit
                  against the one-device artifact on the same sub-batch,
                  images/s; the height-sharded bf16 artifact at batch 1
                  and 8 (its exchanges run over gloo: eager), labels held
                  like the banded eval's, ms and exchanges a batch; every
                  rank's upsample_argmax (whole and windowed) and int8_conv
                  launches by its counters, held equal to its own profile;
                  then serve.main over both kinds with --device
                  cuda:0,cuda:0 on 8 PNGs.
24. hpo        -- the HPO harness (hpo/), last: one trial in-process
                  (hpo.trial.main: the DA CLI with the FC D, --d_head 2 and
                  the combined ordering) on 16 + 16 + 4 image trees at
                  1024x512, bf16, batch 8, 3 epochs of 2 steps (the counts
                  reset before and read after: 2 + 2 CE launches a step,
                  upsample_argmax in each validation); its --nni_output
                  records one intermediate a validation, each equal to the
                  mIoU evaluate returned, then the final one, their max;
                  then run_experiment(max_trials=2, use_nni=False): two
                  trials of the tuner's draws, each a process of its own
                  on the card, rc 0, finite mIoUs, best_miou their max,
                  each trial's seconds; then the trial's DA step at the
                  batch sizes of the three trials, ms a step.

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
PyTorch call computes a CatBottleneck, so ``library_ms`` stays null);
the upsample+argmax and int8 conv records add their launches through the
serve phase's artifacts (``serve_launches``), the upsample+argmax and CE
records their launches in the parallel phase's ranks
(``parallel_launches``) and in the spatial phase's
(``spatial_launches``), and the upsample+argmax and int8 conv records
their launches in the mesh-serve phase's ranks (``mesh_launches``: the
banded int8 eval, the batch-sharded and the height-sharded artifacts),
the int8 conv record its band launches' device ms beside the whole
conv's (``band_device_ms``), and the upsample+argmax and CE records
their launches in the HPO phase's in-process trial (``hpo_launches``).
The last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
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
INT8_SOURCE = "dasemanticsegmentationaml_tpu_torch/csrc/int8_conv.cu"
#: no Pallas original: the XLA ops of the JAX package's int8 block body
INT8_REPLACES = "dasemanticsegmentationaml_tpu/ops/quantize.py:108"
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
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16_tensor": 989e12,
                  "int8_tensor": 1979e12}
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


def device_ms_or_events(fn, match=None):
    """``device_ms``, or where the profiler keeps seeing no kernel (it
    happens now and then on the card's machine) the CUDA-event ms of a
    chain of calls, named so in the by-kernel dict."""
    try:
        return device_ms(fn, match)
    except RuntimeError as e:
        log("timing", f"{e}; timed by CUDA events instead")
        ms = cuda_ms(fn, 20)
        return ms, {"(CUDA events: the profiler saw no kernel)": ms}


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
    """``ops/cuda/<module>`` of another version of the port
    (``baseline_module``)."""
    return baseline_module(root, f"ops.cuda.{module}")


def baseline_module(root, name):
    """The module ``name`` (a dotted path inside the package, as
    ``train.adversarial``) of another version of the port, the package
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
    return importlib.import_module(f"{BASELINE}.{name}")


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
                try:
                    got = ua.upsample_argmax(x, out_hw)
                    torch.cuda.synchronize()
                except Exception:
                    # a fault of the launch, named before it is raised
                    log("kernel", f"upsample_argmax failed on {shape} -> "
                        f"{out_hw} {dtype} {kind}")
                    raise
                want = upsample_argmax.upsample_argmax_reference(x, out_hw)
                check(got.shape == (shape[0], *out_hw)
                      and got.dtype == torch.int32, f"bad output {got.shape}")
                max_err = max(max_err, (got - want).abs().max().item())
                if not torch.equal(got, want):
                    bad.append((shape, out_hw, str(dtype), kind,
                                (got != want).float().mean().item()))
                n += 1
    return n, bad, ua.LAUNCHES - before, max_err


#: (logits shape, output size, bands, the bands launched): the row
#: windows of the height-sharded eval (parallel/spatial.py), each band's
#: output rows from its logits rows and the halo its taps reach
WINDOW_CASES = (
    ((2, 19, 64, 128), (512, 1024), 4, (0, 1, 3)),   # first, middle, last
    ((2, 19, 128, 64), (1024, 512), 2, (0, 1)),      # the spatial phase's
    ((1, 19, 13, 16), (100, 120), 4, (1, 2)),        # ragged taps
    ((2, 3, 16, 32), (128, 256), 3, (1,)),           # the generic instance
)


def window_cases(device):
    """This checkout's windowed upsample_argmax (``window=``) on the bands
    of ``WINDOW_CASES`` x fp32, bf16 x ``KINDS``, each launch synchronised
    and named before a fault is raised: each against the same rows of the
    full kernel and against the windowed plain version, bit for bit.
    Returns (cases, the ones that differ, launches, bands whose taps
    reached past both of their band's edges)."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua
    from dasemanticsegmentationaml_tpu_torch.ops.resize import (
        RowWindow, window_rows)

    before = ua.LAUNCHES
    bad, n, crossing = [], 0, 0
    for shape, out_hw, parts, launched in WINDOW_CASES:
        h, out_h = shape[2], out_hw[0]
        for dtype in (torch.float32, torch.bfloat16):
            for kind in KINDS:
                x = logits_on(device, shape, n, kind, dtype)
                full = ua.upsample_argmax(x, out_hw)
                for s in launched:
                    y0, y1 = s * out_h // parts, (s + 1) * out_h // parts
                    lo, hi = window_rows(y0, y1, h, out_h)
                    window = RowWindow(y0, y1, h, out_h, lo)
                    crossing += (lo < y0 * h // out_h
                                 and hi > -(-y1 * h // out_h))
                    band = x[:, :, lo:hi].contiguous()
                    name = (f"{shape} -> {out_hw} band {s} of {parts} "
                            f"{window} {dtype} {kind}")
                    try:
                        got = ua.upsample_argmax(band, (y1 - y0, out_hw[1]),
                                                 window=window)
                        torch.cuda.synchronize()
                    except Exception:
                        log("kernel", f"windowed upsample_argmax failed on "
                            f"{name}")
                        raise
                    plain = ua.upsample_argmax_reference(
                        band, (y1 - y0, out_hw[1]), window)
                    if not (torch.equal(got, full[:, y0:y1])
                            and torch.equal(got, plain)):
                        bad.append(name)
                    n += 1
    return n, bad, ua.LAUNCHES - before, crossing


def phase_kernel(device):
    """The upsample+argmax kernel bit for bit against its plain version
    (torch.argmax: the first NaN, otherwise the first of the largest) on
    every case, then its row windows against the full kernel's rows and
    the windowed plain version; its counter rises by each call."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua

    n, bad, launches, max_err = kernel_cases(device, ua)
    check(not bad, f"kernel != plain on {len(bad)} of {n} cases: {bad}")
    check(launches == n, f"LAUNCHES rose by {launches}, expected {n}")
    log("kernel", f"{n} cases bit-identical to the plain version "
        f"(fp32+bf16, random-normal+tie-heavy+non-finite); max "
        f"|kernel-plain| = {max_err}; LAUNCHES +{n}")
    n, bad, launches, crossing = window_cases(device)
    full = len(WINDOW_CASES) * 2 * len(KINDS)
    check(not bad, f"windowed kernel != full rows or plain on {len(bad)} "
          f"of {n} windows: {bad}")
    check(launches == n + full, f"LAUNCHES rose by {launches}, expected "
          f"{n} windows + {full} full calls")
    check(crossing > 0, "no window's taps reached past both band edges")
    log("kernel", f"{n} row windows (first, middle and last bands; "
        f"{crossing} whose taps reach past both band edges) bit-identical "
        f"to the full kernel's rows and to the windowed plain version, "
        f"each launch synchronised")
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


#: the int8 kernel's cases: (N, Cin, H, W, Cout, kernel, stride, padding);
#: the first is conv_out.conv at batch 8, 512x1024 (the timed shape), then
#: BiSeNet's other blocks at batch 8 (the stem pair, a stage-3 chain conv,
#: the FFM's 1x1, conv_avg on the pooled map, the context heads, an aux
#: head) and edges (Cin not a multiple of 32, Cout below a tile, a ragged
#: pixel tile, one image)
INT8_CASES = (
    (8, 256, 64, 128, 256, 3, 1, 1),
    (8, 3, 512, 1024, 32, 3, 2, 1),
    (8, 32, 256, 512, 64, 3, 2, 1),
    (8, 128, 64, 128, 64, 3, 1, 1),
    (8, 384, 64, 128, 256, 1, 1, 0),
    (8, 1024, 1, 1, 128, 1, 1, 0),
    (8, 128, 32, 64, 128, 3, 1, 1),
    (8, 128, 64, 128, 64, 3, 1, 1),
    (1, 40, 9, 13, 19, 3, 1, 1),
    (3, 64, 7, 11, 96, 1, 1, 0),
    (1, 3, 37, 29, 32, 3, 2, 1),
)
INT8_DTYPES = (("bfloat16", "bfloat16"), ("float32", "float32"),
               ("bfloat16", "float32"), ("float32", "bfloat16"))


def int8_inputs(device, case, in_dtype, seed=0):
    """Random activations (std 2), int8 weights, per-channel scales and
    biases and the activations' inverse scale (their absmax / 127) of one
    int8 case, on ``device``."""
    import torch

    n, cin, h, w, cout, ks, _, _ = case
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((n, cin, h, w)) * 2).astype(
        np.float32)).to(device=device, dtype=getattr(torch, in_dtype))
    w8 = torch.from_numpy(rng.integers(-127, 128, (cout, cin, ks, ks)).astype(
        np.int8)).to(device)
    out_mul = torch.from_numpy(rng.uniform(1e-5, 1e-3, cout).astype(
        np.float32)).to(device)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(
        np.float32)).to(device)
    inv = (127.0 / x.float().abs().max()).reshape(())
    return x, w8, out_mul, bias, inv


def int8_library(x, w8, out_mul, bias, inv, stride, pad, out_dtype):
    """The one-library-call yardstick (the port never calls it): the
    quantize, im2col of the int8 values (as fp16, exact to 2048, by
    F.unfold), torch._int_mm (cuBLASLt s8 x s8 -> s32), then the same
    fp32 epilogue, back to NCHW."""
    import torch
    import torch.nn.functional as F

    from dasemanticsegmentationaml_tpu_torch.ops.cuda.int8_conv import (
        quantize_activation)

    n, cin, h, w = x.shape
    cout, _, ks, _ = w8.shape
    out_h = (h + 2 * pad - ks) // stride + 1
    out_w = (w + 2 * pad - ks) // stride + 1
    xq = quantize_activation(x, inv)
    cols = F.unfold(xq.to(torch.float16), ks, padding=pad, stride=stride)
    a = cols.transpose(1, 2).reshape(-1, cin * ks * ks).to(torch.int8)
    acc = torch._int_mm(a, w8.reshape(cout, -1).t())
    y = torch.relu(acc.float() * out_mul + bias).to(out_dtype)
    return y.reshape(n, out_h, out_w, cout).permute(0, 3, 1, 2).contiguous()


def bound_int8_conv(case, in_elem, out_elem, scratch=False):
    """Bound of one int8_conv call: it reads the activations and the int8
    weights and writes the output; its work is the s8 x s8 product (2 a
    multiply-add, on the tensor cores), the quantize (a multiply) and the
    epilogue (a multiply, an add, a max) in fp32. ``scratch``: also count
    the prologue's quantized copy of the input, written once and read once
    (the design's floor rather than the function's)."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic

    n, cin, h, w, cout, ks, stride, pad = case
    out_h = (h + 2 * pad - ks) // stride + 1
    out_w = (w + 2 * pad - ks) // stride + 1
    m = n * out_h * out_w
    nbytes = (n * cin * h * w * in_elem + m * cout * out_elem
              + cout * cin * ks * ks + 8 * cout + 4)
    if scratch:
        p = ic.plan(*case, 1)
        nbytes += 2 * n * p.in_h * p.in_w * p.cq * ic.PIECE
    return roofline(nbytes, {"int8_tensor": 2 * m * cout * cin * ks * ks,
                             "fp32": n * cin * h * w + 3 * m * cout})


#: the 35 int8 blocks of BiSeNet-STDC813 under --quantize_filter all at
#: batch 8, 512x1024, as their 24 distinct shapes (N, Cin, H, W, Cout,
#: kernel, stride, padding), each with its blocks (tests/test_torch_int8_conv.py
#: holds the kernels' plan for each; the main path's run finds the same 24)
INT8_ALL_SHAPES = (
    ((8, 3, 512, 1024, 32, 3, 2, 1), ("features.0",)),
    ((8, 32, 256, 512, 64, 3, 2, 1), ("features.1",)),
    ((8, 64, 128, 256, 128, 1, 1, 0), ("features.2.conv_list.0",)),
    ((8, 128, 64, 128, 64, 3, 1, 1), ("features.2.conv_list.1",
                                      "features.3.conv_list.1",
                                      "conv_out16.conv")),
    ((8, 64, 64, 128, 32, 3, 1, 1), ("features.2.conv_list.2",
                                     "features.3.conv_list.2")),
    ((8, 32, 64, 128, 32, 3, 1, 1), ("features.2.conv_list.3",
                                     "features.3.conv_list.3")),
    ((8, 256, 64, 128, 128, 1, 1, 0), ("features.3.conv_list.0",)),
    ((8, 256, 64, 128, 256, 1, 1, 0), ("features.4.conv_list.0",)),
    ((8, 256, 32, 64, 128, 3, 1, 1), ("features.4.conv_list.1",
                                      "features.5.conv_list.1")),
    ((8, 128, 32, 64, 64, 3, 1, 1), ("features.4.conv_list.2",
                                     "features.5.conv_list.2",
                                     "conv_out32.conv")),
    ((8, 64, 32, 64, 64, 3, 1, 1), ("features.4.conv_list.3",
                                    "features.5.conv_list.3")),
    ((8, 512, 32, 64, 256, 1, 1, 0), ("features.5.conv_list.0",)),
    ((8, 512, 32, 64, 512, 1, 1, 0), ("features.6.conv_list.0",)),
    ((8, 512, 16, 32, 256, 3, 1, 1), ("features.6.conv_list.1",
                                      "features.7.conv_list.1")),
    ((8, 256, 16, 32, 128, 3, 1, 1), ("features.6.conv_list.2",
                                      "features.7.conv_list.2")),
    ((8, 128, 16, 32, 128, 3, 1, 1), ("features.6.conv_list.3",
                                      "features.7.conv_list.3")),
    ((8, 1024, 16, 32, 512, 1, 1, 0), ("features.7.conv_list.0",)),
    ((8, 1024, 1, 1, 128, 1, 1, 0), ("cp.conv_avg",)),
    ((8, 1024, 16, 32, 128, 3, 1, 1), ("cp.arm32.conv",)),
    ((8, 128, 32, 64, 128, 3, 1, 1), ("cp.conv_head32",)),
    ((8, 512, 32, 64, 128, 3, 1, 1), ("cp.arm16.conv",)),
    ((8, 128, 64, 128, 128, 3, 1, 1), ("cp.conv_head16",)),
    ((8, 384, 64, 128, 256, 1, 1, 0), ("ffm.convblk",)),
    ((8, 256, 64, 128, 256, 3, 1, 1), ("conv_out.conv",)),
)


def time_int8_shapes(device, card, mods):
    """Each of the 24 shapes of ``INT8_ALL_SHAPES`` in bf16 -> bf16: every
    version in ``mods`` ({label: an ops/cuda/int8_conv module}) held bit
    for bit against this checkout's plain version (this checkout's must
    agree; another version's disagreements are logged), its device ms (the
    profiler's sums of its kernels, the prologue included, and by kernel),
    cuDNN's bf16 conv of the same shape (device ms, autocast's eager path),
    the bound (the function's, and with the prologue's scratch) and the
    share; one line a shape, then each version's sum over the 35 launches
    of one batch. Returns {label: sum ms} and cuDNN's sum."""
    import torch
    import torch.nn.functional as F

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic

    sums = {label: 0.0 for label in mods}
    cudnn_sum, bound_sum, scratch_sum = 0.0, 0.0, 0.0
    for case, blocks in INT8_ALL_SHAPES:
        count = len(blocks)
        x, w8, out_mul, bias, inv = int8_inputs(device, case, "bfloat16", 1)
        stride, pad = case[6], case[7]
        want = ic.int8_conv_reference(x, w8, out_mul, bias, inv, stride, pad,
                                      True, torch.bfloat16)
        parts, dev = [], {}
        for label, mod in mods.items():
            packed = mod.pack_weights(w8)
            fn = functools.partial(mod.int8_conv, x, w8, packed, out_mul,
                                   bias, inv, stride, pad, True,
                                   torch.bfloat16)
            got = fn()
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            if label == "kernel":
                check(same, f"int8_conv != plain at {case}")
            dev[label], by_name = device_ms_or_events(fn, ("int8_conv",))
            sums[label] += count * dev[label]
            kernels = ", ".join(f"{k} {v:.4f}"
                                for k, v in sorted(by_name.items()))
            parts.append(f"{label} {dev[label]:.4f} ms ({kernels})"
                         + ("" if same else " DIFFERS from plain"))
        w_bf16 = torch.randn(case[4], case[1], case[5], case[5],
                             device=device, dtype=torch.bfloat16)
        cudnn, _ = device_ms_or_events(functools.partial(
            F.conv2d, x, w_bf16, stride=stride, padding=pad))
        cudnn_sum += count * cudnn
        bound = bound_int8_conv(case, 2, 2)
        floor = bound_int8_conv(case, 2, 2, scratch=True)
        bound_sum += count * bound[0]
        scratch_sum += count * floor[0]
        log("int8-kernel", f"{case} x{count} ({', '.join(blocks)}), bf16: "
            f"{'; '.join(parts)}; cuDNN bf16 conv {cudnn:.4f} ms "
            f"(kernel / cuDNN {dev['kernel'] / cudnn:.3f}); bound "
            f"{bound[0]:.4f} ms ({bound[1]}), with the scratch "
            f"{floor[0]:.4f} ({floor[1]}); share "
            f"{bound[0] / dev['kernel']:.3f} | {card}")
        del x, w8, want
    for label, total in sums.items():
        log("int8-kernel", f"the 35 launches of one --quantize_filter all "
            f"batch (8, 512x1024), {label}: {total:.4f} device ms; cuDNN's "
            f"bf16 convs of the same shapes {cudnn_sum:.4f}; bound "
            f"{bound_sum:.4f} ({scratch_sum:.4f} with the scratch) | {card}")
    if "baseline" in sums:
        log("int8-kernel", f"this checkout / the baseline over the 35 "
            f"launches: {sums['kernel'] / sums['baseline']:.4f} | {card}")
    torch.cuda.empty_cache()
    return sums, cudnn_sum


def phase_int8_kernel(device, card):
    """The int8 conv kernel bit for bit against its plain version on every
    case x input/output dtype, its counter rising by each call; then at
    conv_out.conv's shape (8, 256, 64, 128) bf16: the kernel by the chain
    and by device time, the plain version (a float64 convolution of the
    int8 values), the library yardstick (im2col + torch._int_mm + the
    epilogue, checked equal) and cuDNN's bf16 convolution of the same
    shape (autocast's eager path, the fp model's conv without BN and
    ReLU), each beside the bound."""
    import torch
    import torch.nn.functional as F

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic

    before = ic.LAUNCHES
    n, bad, max_err = 0, [], 0.0
    for case in INT8_CASES:
        for in_dt, out_dt in INT8_DTYPES:
            x, w8, out_mul, bias, inv = int8_inputs(device, case, in_dt, n)
            args = (x, w8, out_mul, bias, inv, case[6], case[7], True,
                    getattr(torch, out_dt))
            got = ic.int8_conv(x, w8, ic.pack_weights(w8), *args[2:])
            want = ic.int8_conv_reference(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                bad.append((case, in_dt, out_dt, err))
            n += 1
    launches = ic.LAUNCHES - before
    check(not bad, f"int8_conv != plain on {len(bad)} of {n} cases: {bad}")
    check(launches == n, f"int8_conv LAUNCHES rose by {launches}, not {n}")
    log("int8-kernel", f"{n} cases bit-identical to the plain version "
        f"(max |kernel - plain| {max_err}); launches counted {launches}")
    shapes, cudnn_sum = time_int8_shapes(device, card, {"kernel": ic})

    case = INT8_CASES[0]
    x, w8, out_mul, bias, inv = int8_inputs(device, case, "bfloat16")
    packed = ic.pack_weights(w8)
    stride, pad = case[6], case[7]
    kernel = functools.partial(ic.int8_conv, x, w8, packed, out_mul, bias,
                               inv, stride, pad, True, torch.bfloat16)
    plain = functools.partial(ic.int8_conv_reference, x, w8, out_mul, bias,
                              inv, stride, pad, True, torch.bfloat16)
    library = functools.partial(int8_library, x, w8, out_mul, bias, inv,
                                stride, pad, torch.bfloat16)
    check(torch.equal(library(), plain()), "the library yardstick differs "
          "from the plain version")
    w_bf16 = torch.randn(case[4], case[1], 3, 3, device=device,
                         dtype=torch.bfloat16)
    cudnn = functools.partial(F.conv2d, x, w_bf16, padding=pad)
    times = {}
    for name, fn, iters in (("kernel", kernel, 50), ("plain", plain, 2),
                            ("library", library, 20), ("cudnn", cudnn, 50),
                            ("cudnn", cudnn, 50), ("library", library, 20),
                            ("plain", plain, 2), ("kernel", kernel, 50)):
        times.setdefault(name, []).append(
            cuda_ms(fn, iters, warmup=1 if name == "plain" else 3))
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    dev, by_kernel = device_ms(kernel, ("int8_conv",))
    cudnn_dev, _ = device_ms(cudnn)
    bound = bound_int8_conv(case, 2, 2)
    log("int8-kernel", f"conv_out.conv {case[:5]} 3x3 bf16 -> bf16, turns "
        f"A B C D D C B A: kernel {mean['kernel']:.4f} ms "
        f"{[round(t, 4) for t in times['kernel']]} (device {dev:.4f}: "
        f"{', '.join(f'{k} {v:.4f}' for k, v in sorted(by_kernel.items()))}"
        f"), plain "
        f"{mean['plain']:.4f} {[round(t, 4) for t in times['plain']]}, "
        f"library (im2col + _int_mm + epilogue) {mean['library']:.4f} "
        f"{[round(t, 4) for t in times['library']]}, cuDNN bf16 conv "
        f"{mean['cudnn']:.4f} {[round(t, 4) for t in times['cudnn']]} "
        f"(device {cudnn_dev:.4f}); bound {bound[0]:.4f} ms ({bound[1]}), "
        f"share of the bound {bound[0] / dev:.3f} by device time | {card}")
    return {"max_err": max_err, "ms": mean["kernel"],
            "plain_ms": mean["plain"], "library_ms": mean["library"],
            "device_ms": dev, "cudnn_bf16_ms": mean["cudnn"],
            "cudnn_bf16_device_ms": cudnn_dev, "bound": bound,
            "shape": list(case), "all_35_device_ms": shapes["kernel"],
            "all_35_cudnn_bf16_device_ms": cudnn_sum}


def int8_eval_launches(ev):
    """Launches of upsample_argmax and int8_conv so far: each wrapper's
    count, less the calls that only recorded into a captured graph, plus
    the graph replays' (train/evaluate.py)."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import (
        upsample_argmax as ua)

    counters = {"upsample_argmax": ua, "int8_conv": ic}
    return {name: m.LAUNCHES - ev.CAPTURED_LAUNCHES[name]
            + ev.REPLAYED_LAUNCHES[name] for name, m in counters.items()}


def reset_eval_counts(ev):
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import (
        upsample_argmax as ua)

    ua.LAUNCHES = ic.LAUNCHES = 0
    for counts in (ev.CAPTURED_LAUNCHES, ev.REPLAYED_LAUNCHES):
        for name in counts:
            counts[name] = 0


#: blocks each --quantize_filter quantizes in BiSeNet (tests/
#: test_torch_quantize.py holds them against JAX's)
QUANT_BLOCKS = {"all": 35, "head": 1, "heads_cp": 9, "backbone": 26,
                "deep": 25, "head_ch": 3, "head_ffm": 2, "head_stem": 3}


def kernel_launches_seen(prof, names):
    """Launches of each kernel the profile ``prof`` saw on the card, by
    kernel name (``names``: {counter's name: (kernels, ...)}, each kernel a
    tuple of substrings of names whose counts add up: a wrapper call
    launches one of each); graph replays' kernels included. Returns
    {(counter's name, kernel): count}."""
    from torch.autograd import DeviceType

    seen = {(name, kernel): 0 for name, kernels in names.items()
            for kernel in kernels}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for name, kernel in seen:
            if any(part in e.key for part in kernel):
                seen[(name, kernel)] += e.count
    return seen


#: the kernels' names in csrc/ (the profiler's keys hold them): each
#: int8_conv call launches its prologue (NHWC or im2col) and its GEMM
INT8_KERNEL_NAMES = {
    "upsample_argmax": (("upsample_argmax_band_kernel",),),
    "int8_conv": (("int8_conv_quantize_kernel", "int8_conv_im2col_kernel"),
                  ("int8_conv_gemm_kernel",))}


def phase_int8_slice():
    """The slice's main path: the --domain_shift CLI with --quantize_int8
    (filter all) and --eval_scan_window 2 on a 4-image 1024x512 tree, bf16,
    profiled (the counts reset before and read after: eager, warm-up and
    replayed launches, each held equal to the kernels the profiler saw on
    the card), and every int8 block's eager call in that run (the window's
    warm-up: the 35 blocks at their own shapes on the run's activations)
    held bit for bit against the plain version on the same inputs; then
    every --quantize_filter with both --quantize_clip values, eager
    (launches = blocks x batches; filter all equal to the windowed run);
    then head_ch in fp32 on the card against the CPU (bound 1e-3)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dasemanticsegmentationaml_tpu_torch import cli
    from dasemanticsegmentationaml_tpu_torch.ops import quantize
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic
    from dasemanticsegmentationaml_tpu_torch.train import evaluate as ev
    from dasemanticsegmentationaml_tpu_torch.utils.config import (
        QUANTIZE_FILTERS)
    from dasemanticsegmentationaml_tpu_torch.utils.export import read_meta

    kept = []                     # (x, the other arguments, the output)
    wrapper = quantize.int8_conv

    def int8_conv_kept(x, *args):
        out = wrapper(x, *args)
        if not torch.cuda.is_current_stream_capturing():
            kept.append((x, args, out))
        return out

    with tempfile.TemporaryDirectory() as root:
        write_cityscapes(root)
        argv = ["--root", root, "--domain_shift", "True", "--crop_height",
                "512", "--crop_width", "1024", "--eval_batch_size", "2",
                "--quantize_int8", "True", "--calib_batches", "2"]
        quantize.int8_conv = int8_conv_kept
        try:
            reset_eval_counts(ev)
            replays = ev.GRAPH_REPLAYS
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = cli.main(argv + ["--quantize_filter", "all",
                                       "--eval_scan_window", "2", "--dtype",
                                       "bfloat16", "--cuda", "0"])
                secs = time.perf_counter() - t0
            launches = int8_eval_launches(ev)
        finally:
            quantize.int8_conv = wrapper
        n_replays = ev.GRAPH_REPLAYS - replays
        seen = kernel_launches_seen(prof, INT8_KERNEL_NAMES)
        log("int8-slice", f"--domain_shift --quantize_int8 (all) "
            f"--eval_scan_window 2, bf16 cuda:0, profiled: {res} in "
            f"{secs:.2f} s host time (set-up and calibration included); "
            f"launches {launches}, graph replays {n_replays}; kernels the "
            f"profiler saw on the card {seen}")
        check(math.isfinite(res["miou"]) and 0.0 <= res["miou"] <= 1.0,
              f"bad mIoU {res['miou']}")
        check(launches["int8_conv"] > 0 and launches["upsample_argmax"] > 0,
              f"the main path did not launch both kernels: {launches}")
        check(n_replays > 0, "no window was replayed")
        check(all(n == launches[name] for (name, _), n in seen.items()),
              f"the counted launches {launches} are not the kernels the "
              f"card ran {seen}")
        bad, shapes = [], set()
        for x, args, out in kept:
            w8, _packed, out_mul, bias, inv, stride, pad, relu, dtype = args
            want = ic.int8_conv_reference(x, w8, out_mul, bias, inv, stride,
                                          pad, relu, dtype)
            shapes.add((tuple(x.shape), tuple(w8.shape), stride))
            if not torch.equal(out, want):
                bad.append((tuple(x.shape), tuple(w8.shape), stride, (
                    out.float() - want.float()).abs().max().item()))
        log("int8-slice", f"{len(kept)} eager int8 block calls of the main "
            f"path ({len(shapes)} distinct input x weight x stride) against "
            f"the plain version on the same inputs: {len(bad)} differ {bad}")
        check(len(kept) == QUANT_BLOCKS["all"], f"{len(kept)} eager int8 "
              f"calls kept, expected one per block "
              f"({QUANT_BLOCKS['all']})")
        check(not bad, "int8_conv != plain on the main path's blocks")
        del kept[:]
        art = os.path.join(root, "bisenet_int8_all.pt2")
        for clip in ("absmax", "p999"):
            for qfilter in QUANTIZE_FILTERS:
                reset_eval_counts(ev)
                export = (["--export_model", art] if qfilter == "all"
                          and clip == "absmax" else [])
                t0 = time.perf_counter()
                r = cli.main(argv + ["--quantize_filter", qfilter,
                                     "--quantize_clip", clip, "--dtype",
                                     "bfloat16", "--cuda", "0"] + export)
                n = int8_eval_launches(ev)["int8_conv"]
                if export:
                    meta = read_meta(art)
                    log("int8-slice", f"--export_model: {meta}")
                    check(meta["ops"] == ["int8_conv", "upsample_argmax"]
                          and meta["batch"] is None, f"the CLI's int8 "
                          f"artifact: {meta}")
                log("int8-slice", f"{qfilter:9s} {clip:6s}: precision "
                    f"{r['precision']:.6f} mIoU {r['miou']:.6f}, int8_conv "
                    f"launches {n}, {time.perf_counter() - t0:.2f} s")
                check(math.isfinite(r["miou"]), f"bad mIoU {r}")
                check(n == 2 * QUANT_BLOCKS[qfilter],
                      f"{qfilter}: {n} int8 launches, expected "
                      f"{2 * QUANT_BLOCKS[qfilter]}")
                if qfilter == "all" and clip == "absmax":
                    check(r == res, f"all, eager {r} != the window's {res}")
        fp32 = argv + ["--quantize_filter", "head_ch", "--dtype", "float32"]
        gpu = cli.main(fp32 + ["--cuda", "0"])
        cpu = cli.main(fp32 + ["--cuda", "cpu"])
        d_miou = abs(gpu["miou"] - cpu["miou"])
        d_prec = abs(gpu["precision"] - cpu["precision"])
        log("int8-slice", f"head_ch fp32 cuda:0 {gpu} vs cpu {cpu}: |dmIoU| "
            f"{d_miou:.3e}, |dprecision| {d_prec:.3e} (bound 1e-3)")
        check(d_miou <= 1e-3 and d_prec <= 1e-3, "int8 fp32 gpu vs cpu CLI")
    return launches


def eval_batches(device, n=16, batch=8, seed=11, keep=None):
    """``n`` prepared bf16 batches of ``batch`` at 512x1024 on ``device``,
    labels with the ignore label; ``keep``: the indices of the batches
    prepared (every one drawn, so that each is the same)."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.data.pipeline import prepare_batch

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        images = torch.from_numpy(rng.integers(
            0, 256, (batch, 512, 1024, 3), dtype=np.uint8))
        labels = torch.from_numpy(rng.integers(
            0, 20, (batch, 512, 1024), dtype=np.uint8))
        if keep is not None and i not in keep:
            continue
        images, labels = images.pin_memory(), labels.pin_memory()
        labels[labels == 19] = 255
        out.append(prepare_batch(images, labels, device=device,
                                 dtype=torch.bfloat16))
    torch.cuda.synchronize()
    return out


def eval_run(model, batches, device, k, graphs, fetch_timeout=900.0,
             ev=None):
    """One pass of ``eval_counts`` over the fixed batches (bf16, window
    ``k``, the windows kept in ``graphs``; ``ev``: another version's
    train/evaluate module, else this checkout's): (seconds by the host
    clock to the last result, the counts)."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.train import evaluate

    eval_counts = (ev or evaluate).eval_counts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist, correct, total = eval_counts(model, batches, 19,
                                       prepare=lambda b: b, device=device,
                                       amp_dtype=torch.bfloat16,
                                       scan_window=k, graphs=graphs,
                                       fetch_timeout=fetch_timeout)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, (hist.cpu(), int(correct), total)


def eval_busy(call, n_batches):
    """Device busy share of one ``call`` of ``eval_run``: the profiler's
    kernel time (graph replays' kernels included) over its wall time; the
    kernels' ms per batch; and the four heaviest kernels' (name, ms per
    batch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        secs, _ = call()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:4]
    return (busy_ms / (secs * 1e3), busy_ms / n_batches,
            [(e.key[:60], round(e.self_device_time_total / 1e3
                                / n_batches, 4)) for e in top])


def phase_eval_window(device, card, base_root=None):
    """Eval images/s of a fixed list of 16 prepared bf16 batches of 8 at
    512x1024 (no loader; the fetch watchdog's thread as in the CLI),
    seeded weights: eager (with and without the fetch watchdog) against
    --eval_scan_window 8 and 4, in turns A B C D D C B A, then the int8
    models of head_ch and all (calibrated on 4 batches of 8, timed; and on
    4 images) eager against window 8, A B B A; each configuration's
    counts equal eager's bit for bit, and its device busy share and kernel
    ms per batch from one profiled pass. ``base_root``: another version of
    the port (--baseline), whose eager bf16 pass joins the bf16 turns and
    whose own int8 models (its modules, the same seeded weights) windowed
    by 8 join the int8 turns, each as the first and last."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.models.bisenet import build_bisenet
    from dasemanticsegmentationaml_tpu_torch.ops.quantize import (
        PRESET_FILTERS, quantize_model)
    from dasemanticsegmentationaml_tpu_torch.train import evaluate as ev

    model = build_bisenet(19, device=device,
                          generator=torch.Generator().manual_seed(0)).eval()
    batches = eval_batches(device)
    calib = [x for x, _ in batches[:4]]
    n_images = sum(x.shape[0] for x, _ in batches)
    models = {"bf16": model}
    for qfilter in ("head_ch", "all"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models[f"int8 {qfilter}"], _ = quantize_model(
            model, calib, filter_fn=PRESET_FILTERS[qfilter],
            amp_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        secs8 = time.perf_counter() - t0
        t0 = time.perf_counter()
        quantize_model(model, [x[:1] for x in calib],
                       filter_fn=PRESET_FILTERS[qfilter],
                       amp_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        secs1 = time.perf_counter() - t0
        log("eval-window", f"calibration + build, {qfilter}: 4 batches of 8 "
            f"{secs8 * 1e3:.1f} ms; 4 batches of 1 (--calib_batches 4 at "
            f"the CLI's --eval_batch_size 1) {secs1 * 1e3:.1f} ms | {card}")
    base = {}
    if base_root is not None:
        base_ev = baseline_module(base_root, "train.evaluate")
        base_q = baseline_module(base_root, "ops.quantize")
        base_model = baseline_module(base_root, "models.bisenet").build_bisenet(
            19, device=device,
            generator=torch.Generator().manual_seed(0)).eval()
        base["bf16"] = [("baseline", 0, 900.0, model, base_ev)]
        for qfilter in ("head_ch", "all"):
            qm, _ = base_q.quantize_model(
                base_model, calib, filter_fn=base_q.PRESET_FILTERS[qfilter],
                amp_dtype=torch.bfloat16)
            base[f"int8 {qfilter}"] = [("baseline eager", 0, 900.0, qm,
                                        base_ev),
                                       ("baseline window 8", 8, 900.0, qm,
                                        base_ev)]
    results = {}
    for name, m in models.items():
        # (label, window, fetch watchdog's timeout, model, evaluate
        # module); the watchdog's own cost is eager with it against eager
        # without it
        configs = [("eager", 0, 900.0, m, ev), ("window 8", 8, 900.0, m, ev)]
        if name == "bf16":
            configs[1:1] = [("eager, no watchdog", 0, 0.0, m, ev)]
            configs.append(("window 4", 4, 900.0, m, ev))
        theirs = base.get(name, [])
        calls = {label: functools.partial(
            eval_run, cm, batches, device, k, cev.EvalGraphs(),
            fetch_timeout=t, ev=cev) for label, k, t, cm, cev in
            configs + theirs}
        runs = {label: [] for label in calls}
        for call in calls.values():  # warm-up: builds, taps, captures
            call()
        order = [c[0] for c in configs]
        order = ([c[0] for c in theirs] + order + order[::-1]
                 + [c[0] for c in theirs])
        ref = None
        for label in order:
            secs, counts = calls[label]()
            ref = ref or counts
            check(torch.equal(counts[0], ref[0]) and counts[1] == ref[1],
                  f"{name} {label}: counts differ from {order[0]}'s")
            runs[label].append(n_images / secs)
        busy = {label: eval_busy(call, len(batches))
                for label, call in calls.items()}
        for label, rate in runs.items():
            log("eval-window", f"{name}, {label}: mean "
                f"{sum(rate) / len(rate):.1f} images/s, turns "
                f"{[round(r, 1) for r in rate]}, device busy "
                f"{busy[label][0]:.3f}, kernels {busy[label][1]:.3f} "
                f"ms/batch, heaviest {busy[label][2]} | {card}")
        results[name] = {label: (sum(v) / len(v), busy.get(label))
                         for label, v in runs.items()}
    for qfilter in ("head_ch", "all"):
        mine = results[f"int8 {qfilter}"]["window 8"][0]
        line = (f"int8 {qfilter} window 8: {mine:.1f} images/s, "
                f"{mine / results['bf16']['window 8'][0]:.3f}x bf16's "
                f"window 8")
        if base:
            parent = results[f"int8 {qfilter}"]["baseline window 8"][0]
            line += f", {mine / parent:.3f}x the baseline's window 8"
        log("eval-window", f"{line} | {card}")
    eager_pairs = (("bf16", "baseline"), ("int8 head_ch", "baseline eager"),
                   ("int8 all", "baseline eager"))
    for name, theirs in eager_pairs if base else ():
        mine, parent = results[name]["eager"][0], results[name][theirs][0]
        log("eval-window", f"{name} eager (the kernels through the custom "
            f"ops): {mine:.1f} images/s against the baseline's eager "
            f"{parent:.1f} ({mine / parent:.4f}x) | {card}")
    return results


#: the serving artifact's frames (H, W), the batch sizes its labels are
#: held against ``predict`` at, and the runner's input: 2048x1024 PNGs
SERVE_HW = (512, 1024)
SERVE_BATCHES = (1, 3, 8)
SERVE_IMAGES = 19


def served(what, b, fn):
    """``fn()``, synchronised, with ``what`` and the batch size ``b`` in
    the error it raises (an asynchronous fault is named by its batch)."""
    import torch

    try:
        out = fn()
        torch.cuda.synchronize()
        return out
    except Exception as e:
        raise RuntimeError(f"{what}, batch {b}: {e}") from e


def serve_counts():
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import (
        upsample_argmax as ua)

    return {"upsample_argmax": ua.LAUNCHES, "int8_conv": ic.LAUNCHES}


def label_share(got, want):
    """The share of equal labels, and where not all are, the count."""
    same = float((got == want).float().mean())
    return same, int((got != want).sum())


def write_serve_tree(root, n=SERVE_IMAGES, seed=17):
    """``n`` 2048x1024 RGB PNGs from a numpy seed, the last in a
    subdirectory with the stem of the first (``sub/s_000.png``)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "sub"), exist_ok=True)
    paths = [os.path.join(root, f"s_{i:03d}.png") for i in range(n - 1)]
    paths.append(os.path.join(root, "sub", "s_000.png"))
    for path in paths:
        Image.fromarray(rng.integers(0, 255, (1024, 2048, 3),
                                     dtype=np.uint8)).save(path)
    return paths


def run_serve_cli(artifact, images, output):
    """``python -m dasemanticsegmentationaml_tpu_torch.serve`` in a fresh
    process under ``-X importtime``: (its summary line's numbers, the
    modules it imported)."""
    import re

    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "dasemanticsegmentationaml_tpu_torch.serve", artifact, "--images",
         images, "--output", output, "--batch_size", "8", "--color"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"serve exited with {proc.returncode}: "
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    imported = {line.split("|")[-1].strip() for line in
                proc.stderr.splitlines() if line.startswith("import time:")}
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("served "))
    nums = {
        "seconds": float(re.search(r"in ([\d.]+)s", line).group(1)),
        "first": float(re.search(r"first batch ([\d.]+)s", line).group(1)),
        "steady": float(re.search(r"then ([\d.]+) img/s", line).group(1)),
        "decode_ms": float(re.search(r"decode ([\d.]+) ms", line).group(1)),
        "launches": json.loads(re.search(r"kernel launches (\{.*\})", line)
                               .group(1).replace("'", '"'))}
    return line, nums, imported


#: ``replays_profiled``'s process: load the artifact, replay it 3 times at
#: batch 8 by ``serve.Program`` under the profiler; print the counted
#: launches and the card's kernels by name
REPLAYS_PROFILED = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from dasemanticsegmentationaml_tpu_torch import serve
from dasemanticsegmentationaml_tpu_torch.utils.export import load_exported
device = torch.device("cuda", 0)
runner = serve.Program(load_exported(sys.argv[1]), device)
frames = torch.randint(0, 256, (8, 512, 1024, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0))
runner(frames)
before = dict(runner.replayed)
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    for _ in range(3):
        runner(frames)
kernels = {}
for e in prof.key_averages():
    if e.device_type == DeviceType.CUDA:
        kernels[e.key] = kernels.get(e.key, 0) + e.count
print(json.dumps({"replayed": {k: runner.replayed[k] - before[k]
                               for k in before}, "kernels": kernels}))
"""


def replays_profiled(artifact):
    """3 replays of ``artifact`` profiled in a fresh process: (the launches
    ``serve.Program`` counted, the kernels the profiler saw, as
    ``kernel_launches_seen``). Late in this long process the profiler has
    lost kernel records of graph replays (98 to 102 of 105 int8 kernels,
    in three passes of one run) where a fresh process saw every one."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", REPLAYS_PROFILED, artifact],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the profiled replays exited with "
                           f"{proc.returncode}: {proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    seen = {(name, kernel): sum(n for key, n in got["kernels"].items()
                                if any(part in key for part in kernel))
            for name, kernels in INT8_KERNEL_NAMES.items()
            for kernel in kernels}
    return got["replayed"], seen


def phase_serve(device, card, window=None):
    """The serving path at full width: seeded BiSeNet-STDC813 in bf16 and
    its int8 ``all`` model, each exported (``utils/export.py``) as a
    symbolic-batch artifact and a ``1,8`` bundle (seconds and bytes; the
    saved graph holds the ops). Loaded back, the artifact's labels against
    ``train/evaluate.py::predict`` on the same prepared batch at batch 1, 3
    and 8 (and each bundle program at its batch), synchronised after each
    batch; ``serve.Program``'s CUDA-graph replay against the eager call,
    bit for bit; the launches through the artifact, eager and replayed
    (1 upsample_argmax a batch, 35 int8_conv calls an int8 batch), and in
    a fresh process (``replays_profiled``) replayed under the profiler and
    held equal to the kernels it saw. Then the artifact alone on 16
    prepared device uint8 batches of 8, eager against replayed in turns A
    B B A (images/s, device busy share, kernel ms a batch, peak memory;
    beside the eval-window phase's ``window``); then the runner, ``python
    -m ...serve --batch_size 8 --color`` in a fresh process on 19
    2048x1024 PNGs (one in a subdirectory with a colliding stem), for the
    bf16 artifact and the int8 bundle: the output names, no module of
    ``models/`` imported, labels against in-process ``predict`` on the
    same decoded frames (>= 0.999 of pixels: another process may choose
    other cuDNN algorithms), colours equal to the palette's, and its
    first-batch seconds, steady images/s and decode ms an image. Returns
    the launches counted through the artifacts, by kernel."""
    import torch

    from dasemanticsegmentationaml_tpu_torch import serve
    from dasemanticsegmentationaml_tpu_torch.data.labels import (
        train_id_colors)
    from dasemanticsegmentationaml_tpu_torch.data.pipeline import (
        prepare_batch)
    from dasemanticsegmentationaml_tpu_torch.data.transforms_host import (
        load_image)
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        build_bisenet)
    from dasemanticsegmentationaml_tpu_torch.ops.quantize import (
        PRESET_FILTERS, quantize_model)
    from dasemanticsegmentationaml_tpu_torch.train.evaluate import predict
    from dasemanticsegmentationaml_tpu_torch.utils import export as ex
    from PIL import Image

    bf16 = torch.bfloat16
    h, w = SERVE_HW
    rng = np.random.default_rng(13)
    frames = [torch.from_numpy(rng.integers(0, 256, (8, h, w, 3),
                                            dtype=np.uint8)).pin_memory()
              for _ in range(16)]
    zeros = torch.zeros((8, h, w), dtype=torch.uint8)

    def prepared(u8):
        return prepare_batch(u8, zeros[:u8.shape[0]], device=device,
                             dtype=bf16)[0]

    model = build_bisenet(19, device=device,
                          generator=torch.Generator().manual_seed(0)).eval()
    qmodel, _ = quantize_model(model, [prepared(f) for f in frames[:4]],
                               filter_fn=PRESET_FILTERS["all"],
                               amp_dtype=bf16)
    models = {"bf16": (model, ["upsample_argmax"], 0),
              "int8 all": (qmodel, ["int8_conv", "upsample_argmax"],
                           QUANT_BLOCKS["all"])}
    launches = {"upsample_argmax": 0, "int8_conv": 0}
    dev_frames = [f.to(device) for f in frames]
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        images = os.path.join(tmp, "images")
        paths = write_serve_tree(images)
        decoded = np.stack([load_image(p, SERVE_HW, False) for p in paths])
        for name, (m, ops, blocks) in models.items():
            tag = name.replace(" ", "_")
            art = os.path.join(tmp, f"{tag}.pt2")
            bundle = os.path.join(tmp, f"{tag}_bundle.zip")
            t0 = time.perf_counter()
            ex.export_inference(m, h, w, amp_dtype=bf16, device=device,
                                path=art)
            secs = time.perf_counter() - t0
            t0 = time.perf_counter()
            ex.export_inference_bundle(m, h, w, [1, 8], amp_dtype=bf16,
                                       device=device, path=bundle)
            secs_b = time.perf_counter() - t0
            meta, meta_b = ex.read_meta(art), ex.read_meta(bundle)
            log("serve", f"{name}: exported the symbolic-batch artifact in "
                f"{secs:.2f} s, {os.path.getsize(art)} bytes, and the 1,8 "
                f"bundle in {secs_b:.2f} s, {os.path.getsize(bundle)} bytes;"
                f" {meta} | {card}")
            check(meta["ops"] == ops and meta_b["ops"] == ops
                  and meta["device"] == "cuda" and meta["batch"] is None
                  and meta_b["batches"] == [1, 8],
                  f"{name}: the artifacts' metadata {meta}, {meta_b}")
            t0 = time.perf_counter()
            module = ex.load_exported(art)
            programs = {b: e.program.module()
                        for b, e in ex.read_exported_bundle(bundle).items()}
            log("serve", f"{name}: loaded both in "
                f"{time.perf_counter() - t0:.2f} s")
            runner = serve.Program(module, device)
            with torch.inference_mode():
                for b in SERVE_BATCHES:
                    u8 = frames[1][:b]
                    want = served(f"{name} predict", b, lambda: predict(
                        m, prepared(u8), True, bf16))
                    got = served(f"{name} artifact", b,
                                 lambda: module(u8.to(device)))
                    same = label_share(got, want)
                    replay = served(f"{name} graph replay", b,
                                    lambda: runner(u8))
                    log("serve", f"{name}, batch {b}: the artifact against "
                        f"predict {same[0]:.6f} of labels equal ({same[1]} "
                        f"differ); graph replay equal to the eager call: "
                        f"{torch.equal(replay, got.cpu())}")
                    check(same[0] >= 0.999, f"{name} batch {b}: the "
                          f"artifact agrees with predict on {same[0]}")
                    check(torch.equal(replay, got.cpu()),
                          f"{name} batch {b}: replay != eager")
                    if b in programs:
                        got_b = served(f"{name} bundle b{b}", b,
                                       lambda: programs[b](u8.to(device)))
                        same_b = label_share(got_b, want)
                        log("serve", f"{name}, bundle program b{b}: "
                            f"{same_b[0]:.6f} of labels equal to predict")
                        check(same_b[0] >= 0.999, f"{name} bundle b{b}")
                # launches: three eager batches of 8, then three replays
                before = serve_counts()
                for i in range(3):
                    served(f"{name} artifact", 8,
                           lambda: module(dev_frames[i]))
                eager = {k: v - before[k]
                         for k, v in serve_counts().items()}
                replayed = dict(runner.replayed)
                for i in range(3):
                    served(f"{name} graph replay", 8,
                           lambda: runner(frames[i]))
                replayed = {k: runner.replayed[k] - replayed[k]
                            for k in replayed}
            fresh, seen = replays_profiled(art)
            log("serve", f"{name}: launches through the artifact, 3 eager "
                f"batches of 8 {eager}, 3 replays {replayed}; in a fresh "
                f"process, 3 replays counted {fresh}, and the kernels the "
                f"profiler saw there {seen}")
            want_n = {"upsample_argmax": 3, "int8_conv": 3 * blocks}
            check(eager == want_n and replayed == want_n and fresh == want_n,
                  f"{name}: launches {eager} eager, {replayed} and {fresh} "
                  f"replayed, expected {want_n}")
            check(all(n == fresh[k] for (k, _), n in seen.items()),
                  f"{name}: the replays' counted launches {fresh} are not "
                  f"the kernels the card ran {seen}")
            for k in launches:
                launches[k] += eager[k] + replayed[k]
            time_artifact(name, module, runner, dev_frames, device, card,
                          window)
            out = os.path.join(tmp, f"out_{tag}")
            # the bf16 artifact, and the int8 model's bundle (its tail of 3
            # on the b8 program)
            kind = "artifact" if name == "bf16" else "1,8 bundle"
            line, nums, imported = run_serve_cli(
                art if name == "bf16" else bundle, images, out)
            log("serve", f"{name} runner on the {kind}: {line}")
            bad = sorted(mod for mod in imported if mod.startswith((
                "dasemanticsegmentationaml_tpu_torch.models", "jax")))
            check(not bad, f"the serving process imported {bad}")
            # 3 batches (8, 8, the tail padded to 8) replayed, and the
            # forward the warm-up ran before the one capture
            check(nums["launches"] == {"upsample_argmax": 4,
                                       "int8_conv": 4 * blocks},
                  f"the runner's launches {nums['launches']}, expected one "
                  f"forward a batch and the warm-up's")
            names = sorted(os.path.relpath(os.path.join(dp, f), out)
                           for dp, _, fs in os.walk(out) for f in fs)
            want_names = sorted(
                [f"s_{i:03d}{s}.png" for i in range(SERVE_IMAGES - 1)
                 for s in ("_trainIds", "_color")]
                + [os.path.join("sub", f"s_000{s}.png")
                   for s in ("_trainIds", "_color")])
            check(names == want_names, f"the runner wrote {names}")
            palette = train_id_colors()
            agree, colours = [], True
            with torch.inference_mode():
                for s in range(0, len(paths), 8):
                    # batched as the runner batches: the tail padded to 8
                    # (cuDNN may choose another algorithm at batch 3)
                    chunk = decoded[s:s + 8]
                    u8 = torch.from_numpy(np.concatenate([chunk, np.zeros(
                        (8 - len(chunk), *chunk.shape[1:]), np.uint8)]))
                    want = predict(m, prepared(u8), True, bf16).cpu().numpy()
                    for path, pred in zip(paths[s:s + 8], want):
                        rel = os.path.splitext(
                            os.path.relpath(path, images))[0]
                        got = np.asarray(Image.open(os.path.join(
                            out, f"{rel}_trainIds.png")))
                        agree.append(float((got == pred).mean()))
                        colour = np.asarray(Image.open(os.path.join(
                            out, f"{rel}_color.png")).convert("RGB"))
                        colours &= bool((colour == palette[got]).all())
            log("serve", f"{name} runner: labels against in-process predict"
                f" on the same decoded frames: the least share equal "
                f"{min(agree):.6f}, mean {sum(agree) / len(agree):.6f}; "
                f"colours equal to the palette: {colours}; first batch "
                f"{nums['first']:.3f} s, steady {nums['steady']:.1f} "
                f"images/s, decode {nums['decode_ms']:.1f} ms an image "
                f"(PIL or the native decoder, one thread) | {card}")
            check(min(agree) >= 0.999, f"{name}: the runner's labels agree "
                  f"with predict on {min(agree)}")
            check(colours, f"{name}: _color.png != palette[_trainIds.png]")
    return launches


def time_artifact(name, module, runner, dev_frames, device, card,
                  window=None):
    """The loaded artifact alone on prepared device uint8 batches of 8:
    the eager call against ``runner``'s graph replay (its batch-8 graph,
    the slot filled by a device copy), outputs left on the card and one
    synchronise at the end, in turns A B B A; images/s, device busy share
    and kernel ms a batch from one profiled pass each, peak memory."""
    import torch

    slot, _, graph, _ = runner.graphs[8]
    n_images = 8 * len(dev_frames)

    def eager():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            outs = [module(f) for f in dev_frames]
        torch.cuda.synchronize()
        del outs
        return time.perf_counter() - t0, None

    def replay():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():       # the slot is an inference tensor
            for f in dev_frames:
                slot.copy_(f)
                graph.replay()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, None

    calls = {"eager": eager, "graph replay": replay}
    rates = {k: [] for k in calls}
    for k in ("eager", "graph replay", "graph replay", "eager"):
        rates[k].append(n_images / calls[k]()[0])
    for k, call in calls.items():
        torch.cuda.reset_peak_memory_stats(device)
        busy, kernel_ms, top = eval_busy(call, len(dev_frames))
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        mean = sum(rates[k]) / len(rates[k])
        line = (f"{name} artifact, {k}, batch 8, 512x1024: {mean:.1f} "
                f"images/s (turns {[round(r, 1) for r in rates[k]]}), "
                f"device busy {busy:.3f}, kernels {kernel_ms:.3f} ms a "
                f"batch, peak memory {peak:.3f} GiB, heaviest {top}")
        if window is not None:
            key = "bf16" if name == "bf16" else "int8 all"
            line += (f"; eval-window phase: eager "
                     f"{window[key]['eager'][0]:.1f}, window 8 "
                     f"{window[key]['window 8'][0]:.1f} images/s")
        log("serve", f"{line} | {card}")


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
    from dasemanticsegmentationaml_tpu_torch.utils.export import read_meta
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua

    with tempfile.TemporaryDirectory() as root:
        write_cityscapes(root)
        argv = ["--root", root, "--domain_shift", "True",
                "--crop_height", "512", "--crop_width", "1024",
                "--eval_batch_size", "2"]
        art = os.path.join(root, "bisenet_bundle.zip")
        ua.LAUNCHES = 0
        t0 = time.perf_counter()
        res = cli.main(argv + ["--dtype", "bfloat16", "--cuda", "0",
                               "--export_model", art,
                               "--export_batches", "1,8"])
        secs = time.perf_counter() - t0
        launches = ua.LAUNCHES
        meta = read_meta(art)
        log("slice", f"bf16 cuda:0 {res} in {secs:.2f} s host time "
            f"(set-up and the export included); kernel launches "
            f"{launches}; --export_model --export_batches 1,8: {meta}")
        check(meta["ops"] == ["upsample_argmax"] and meta["device"] == "cuda"
              and meta["batches"] == [1, 8], f"the CLI's bundle: {meta}")
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
    from dasemanticsegmentationaml_tpu_torch.train import evaluate as ev
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
                "--jsonl_log", log_path, "--eval_scan_window", "2"]
        reset_ce_counts()
        replays = ev.GRAPH_REPLAYS
        t0 = time.perf_counter()
        res = cli.main(argv)
        secs = time.perf_counter() - t0
        launches = ce_counts()
        replays = ev.GRAPH_REPLAYS - replays
        with open(log_path) as f:
            losses = [json.loads(line)["loss"] for line in f]
        steps = epochs * steps_per_epoch
        log("train", f"supervised CLI, batch 8, 1024x512, bf16, {steps} "
            f"steps, validation windows of 2: {res}; epoch losses "
            f"{losses}; {secs:.2f} s host time (set-up, validation and "
            f"checkpoints included); launches {launches} (upsample_argmax: "
            f"the wrapper's calls), graph replays {replays}")
        # one validation (epoch 1) and the final evaluation, two windows
        # each, the second replaying the first's capture
        check(replays == 4, f"{replays} window replays, expected 4")
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


#: the DA CLI runs of phase_da: (name, flags, steps per epoch); the last
#: two augment the source batches, on the card and on the host
DA_RUNS = (("FC D, interleaved", ["--depthwise", "False",
                                  "--da_step_mode", "interleaved"], 2),
           ("DW+BN D, combined", ["--depthwise", "True", "--batch_norm", "True",
                                  "--da_step_mode", "combined"], 2),
           ("FC D, --aug_type H-RP on the card", [
               "--depthwise", "False", "--aug_type", "H-RP"], 1),
           ("FC D, --aug_type B-GS-R on the host, labels warped", [
               "--depthwise", "False", "--aug_type", "B-GS-R",
               "--host_augment", "True", "--augment_labels", "True"], 1))


def phase_da():
    """The DA CLI at batch 8, 1024x512, bf16, 2 epochs, in both step modes
    (2 steps an epoch) and with the source augmented by H-RP on the card
    and by B-GS-R on the host (1 step an epoch); then the supervised CLI
    on the GTA5 tree with CS-HF on the card (1 step). The kernels' counts
    are reset before each run and read after it."""
    import torch

    from dasemanticsegmentationaml_tpu_torch import cli

    epochs = 2
    launches_by_run = {}
    with tempfile.TemporaryDirectory() as root:
        gta, cs = os.path.join(root, "gta5"), os.path.join(root, "cityscapes")
        write_gtav(gta, n=16)
        write_cityscapes(cs, "train", n=16, seed=1)
        write_cityscapes(cs, "val", n=4)
        for n, (name, flags, steps_per_epoch) in enumerate(DA_RUNS):
            steps = epochs * steps_per_epoch
            # the two heads that do not feed D go through the fused CE
            # once each per step, forward and backward, in both modes
            expect = 2 * steps
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
            reset_ce_counts()
            t0 = time.perf_counter()
            res = cli.main(argv)
            secs = time.perf_counter() - t0
            launches = ce_counts()
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
            launches_by_run[name] = launches
        launches_by_run["supervised GTA5, --aug_type CS-HF"] = (
            train_gtav_augmented(root, gta))
    return launches_by_run


def train_gtav_augmented(root, gta):
    """The supervised CLI on the GTA5 tree (12 train images, 4 val) with
    CS-HF on the card, batch 8, bf16, 1 step; returns its launch counts."""
    from dasemanticsegmentationaml_tpu_torch import cli

    log_path = os.path.join(root, "gtav.jsonl")
    argv = ["--dataset", "GTAV", "--root", gta, "--aug_type", "CS-HF",
            "--batch_size", "8", "--num_epochs", "1",
            "--dtype", "bfloat16", "--cuda", "0", "--tensorboard", "False",
            "--save_model_path", os.path.join(root, "ck_gtav"),
            "--jsonl_log", log_path]
    reset_ce_counts()
    t0 = time.perf_counter()
    res = cli.main(argv)
    secs = time.perf_counter() - t0
    launches = ce_counts()
    with open(log_path) as f:
        losses = [json.loads(line)["loss"] for line in f]
    log("da", f"supervised CLI, --dataset GTAV --aug_type CS-HF, batch 8, "
        f"1024x512, bf16, 1 step: {res}; loss {losses}; {secs:.2f} s host "
        f"time (set-up and validation included); launches {launches}")
    check(launches["fused_ce_fwd"] == 3 and launches["fused_ce_bwd"] == 3,
          f"fused CE launches {launches}, expected 3 each")
    check(launches["upsample_argmax"] > 0,
          "validation did not launch upsample_argmax")
    check(len(losses) == 1 and math.isfinite(losses[0]),
          f"bad losses {losses}")
    return launches


AUG_TYPES = ("CS-HF", "H-RP", "B-GS-R")
#: the device augmentation's training path, card against CPU (as
#: tests/test_torch_cuda.py::test_augment_on_card_equals_cpu): images
#: within 1e-2 on the 0-255 scale and labels equal, each on at least this
#: share of the pixels; the rest are float32 floor and round ties
AUG_SHARE = 0.999


def phase_augment(device, card):
    """The device augmentation (data/augment.py) on the card against the
    same function on the CPU with the same explicit parameters, at batch
    8, 1024x512: the training path of each menu within ``AUG_SHARE``, the
    pil-exact replay of two samples bit for bit (CS-HF, B-GS-R; also
    against the numpy plain version) or within JAX's envelope (H-RP: at
    most 1e-3 of the pixels, by at most 1; labels equal). Then its time on
    the card per batch, labels warped or not (CUDA events, the host path
    included, and device time by profiler kernel sums), and the native
    host ops' time per image on one thread beside their numpy plain
    version's. Returns the times."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.data import augment as aug
    from dasemanticsegmentationaml_tpu_torch.data import augment_pil_exact as px
    from dasemanticsegmentationaml_tpu_torch.data import host_augment as ha
    from dasemanticsegmentationaml_tpu_torch.data import native_augment as na

    rng = np.random.default_rng(3)
    n, h, w = 8, 1024, 512
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    labels = rng.integers(0, 35, (n, h, w), dtype=np.uint8)
    imgs_cpu, labs_cpu = torch.from_numpy(images).float(), torch.from_numpy(
        labels)
    imgs, labs = imgs_cpu.to(device), labs_cpu.to(device)
    for aug_type in AUG_TYPES:
        params = aug.sample_params(aug_type, n, h, w,
                                   torch.Generator().manual_seed(1),
                                   apply_prob=0.75)
        want = aug.apply_params(imgs_cpu, labs_cpu, aug_type, params,
                                augment_labels=True)
        got = aug.apply_params(imgs, labs, aug_type,
                               {k: v.to(device) for k, v in params.items()},
                               augment_labels=True)
        img_share = float(((got[0].cpu() - want[0]).abs() <= 1e-2)
                          .float().mean())
        label_share = float((got[1].cpu() == want[1]).float().mean())
        log("augment", f"{aug_type}, training path, batch 8, 1024x512, "
            f"{int(params['applied'].sum())} of 8 applied, card vs CPU: "
            f"images within 1e-2 on {img_share:.6f} of the pixels, labels "
            f"equal on {label_share:.6f} (bound {AUG_SHARE})")
        check(img_share >= AUG_SHARE and label_share >= AUG_SHARE,
              f"{aug_type}: the card's training path disagrees")
        for i in range(2):
            p = ha.sample_params(aug_type, ha.rng_for(2, 0, i), h, w,
                                 apply_prob=1.0)
            want = aug.apply_family_with_params(
                imgs_cpu[i], labs_cpu[i], aug_type, p, augment_labels=True)
            got = aug.apply_family_with_params(
                imgs[i], labs[i], aug_type, p, augment_labels=True)
            d = (got[0].cpu() - want[0]).abs()
            plain = torch.from_numpy(px.apply_family(images[i], aug_type, p))
            d_plain = (got[0].cpu() - plain.float()).abs()
            log("augment", f"{aug_type}, pil-exact replay of sample {i}, "
                f"card vs CPU: {float((d > 0).float().mean()):.6f} of the "
                f"pixels differ, by at most {float(d.max())}; labels equal "
                f"{torch.equal(got[1].cpu(), want[1])}; vs the numpy plain "
                f"version: {float((d_plain > 0).float().mean()):.6f}, at "
                f"most {float(d_plain.max())}")
            check(torch.equal(got[1].cpu(), want[1]),
                  f"{aug_type}: pil-exact labels differ")
            if aug_type == "H-RP":
                check(float((d > 0).float().mean()) <= 1e-3
                      and float(d.max()) <= 1.0,
                      "H-RP: pil-exact replay outside the envelope")
            else:
                check(not d.any() and not d_plain.any(),
                      f"{aug_type}: pil-exact replay not bit-identical")

    times = {}
    for aug_type in AUG_TYPES:
        for warp_labels in (False, True):
            def run():
                aug.augment_batch(imgs, labs, aug_type,
                                  aug.batch_generator(0, 0, 0, device),
                                  augment_labels=warp_labels)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            ms = cuda_ms(run, 20)
            extra = (torch.cuda.max_memory_allocated(device) - base) / 2**20
            dev_ms, _ = device_ms(run, n=10)
            times[(aug_type, warp_labels)] = (ms, dev_ms)
            log("augment", f"{aug_type} on the card, batch 8, 1024x512 "
                f"fp32, augment_labels {warp_labels}: {ms:.4f} ms/batch "
                f"(CUDA events), device {dev_ms:.4f} ms (kernel sums); "
                f"{extra:.1f} MiB above the batch at its peak | {card}")

    img, lab = images[0], labels[0]
    for aug_type in AUG_TYPES:
        p = ha.sample_params(aug_type, ha.rng_for(0, 0, 1), h, w,
                             apply_prob=1.0)
        check(np.array_equal(na.apply_family(img, aug_type, p),
                             px.apply_family(img, aug_type, p))
              and np.array_equal(na.apply_family_label(lab, aug_type, p),
                                 ha.apply_family_label(lab, aug_type, p)),
              f"{aug_type}: the native ops differ from numpy")

        def per_image(fn, reps):
            fn()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps

        native = per_image(lambda: na.apply_family(img, aug_type, p), 20)
        native_label = per_image(
            lambda: na.apply_family_label(lab, aug_type, p), 20)
        plain = per_image(lambda: px.apply_family(img, aug_type, p), 3)
        times[(aug_type, "host")] = (native, native_label, plain)
        log("augment", f"{aug_type} on the host, 1024x512, applied, one "
            f"thread: native {native:.3f} ms/image (+ {native_label:.3f} "
            f"for its label), numpy plain version {plain:.3f} ms/image")
    return times


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


class RunDied(Exception):
    """Ends a CLI run as an epoch starts: a run that died there."""


def run_cli(argv, die_at=None):
    """``cli.main(argv)``; with ``die_at`` the run dies as epoch
    ``die_at`` starts (``Loader.set_epoch`` raises), after every
    checkpoint of the epoch before. Returns the result, or None when it
    died."""
    from dasemanticsegmentationaml_tpu_torch import cli
    from dasemanticsegmentationaml_tpu_torch.data.pipeline import Loader

    set_epoch = Loader.set_epoch

    def dying(self, epoch):
        if epoch == die_at:
            raise RunDied(epoch)
        set_epoch(self, epoch)

    if die_at is not None:
        Loader.set_epoch = dying
    try:
        return cli.main(argv)
    except RunDied:
        return None
    finally:
        Loader.set_epoch = set_epoch


def same_tree(a, b):
    """Nested dicts and lists of tensors and plain values, bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    return a == b


@contextlib.contextmanager
def state_probes(keep_epoch=None):
    """While open: every restore by ``cli.maybe_resume`` is recorded as
    (alias, start epoch, seconds, whether the module, optimizer and
    accumulator then equal the file's state bit for bit), and every save
    as the seconds of its device-to-host copy (``checkpoint.train_state``)
    and of its write (``state_io.save_train_state``). With
    ``keep_epoch``, each time the marker reads that epoch the state
    directory is copied to ``<dir>_kept``: the run's own state at the end
    of that epoch."""
    import shutil

    import torch

    from dasemanticsegmentationaml_tpu_torch import cli
    from dasemanticsegmentationaml_tpu_torch.utils import checkpoint, state_io

    probes = {"restores": [], "to_host_s": [], "write_s": []}
    real_resume, real_state = cli.maybe_resume, checkpoint.train_state
    real_save, real_marker = (state_io.save_train_state,
                              state_io.write_epoch_marker)

    def resume(args, module, optimizer, accumulator=None, alias="latest"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = real_resume(args, module, optimizer, accumulator, alias)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if args.resume:
            saved = state_io.restore_train_state(args.resume, alias)
            now = state_io.to_host({
                "model": module.state_dict(),
                "optimizer": optimizer.state_dict(),
                "accumulator": (None if accumulator is None
                                else accumulator.state_dict())})
            same = all(same_tree(saved[k], now[k]) for k in now)
            probes["restores"].append((alias, start, secs, same))
        return start

    def train_state(*args, **kw):
        t0 = time.perf_counter()
        out = real_state(*args, **kw)
        probes["to_host_s"].append(time.perf_counter() - t0)
        return out

    def save(directory, name, state):
        t0 = time.perf_counter()
        out = real_save(directory, name, state)
        probes["write_s"].append(time.perf_counter() - t0)
        return out

    def marker(directory, epoch):
        real_marker(directory, epoch)
        if epoch == keep_epoch:
            shutil.copytree(directory, directory + "_kept",
                            dirs_exist_ok=True)

    cli.maybe_resume, checkpoint.train_state = resume, train_state
    state_io.save_train_state = save
    state_io.write_epoch_marker = marker
    try:
        yield probes
    finally:
        cli.maybe_resume, checkpoint.train_state = real_resume, real_state
        state_io.save_train_state = real_save
        state_io.write_epoch_marker = real_marker


def update_l2(final, other, init):
    """||other - final|| / ||final - init|| over the weights (the running
    statistics and counters left out), in fp64."""
    diff = upd = 0.0
    for key, a in final.items():
        if key.endswith(("running_mean", "running_var",
                         "num_batches_tracked")):
            continue
        a = a.double().cpu()
        diff += float((other[key].double().cpu() - a).pow(2).sum())
        upd += float((a - init[key].double().cpu()).pow(2).sum())
    return (diff / upd) ** 0.5


def ce_counts():
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua

    return {"fused_ce_fwd": fc.FWD_LAUNCHES, "fused_ce_bwd": fc.BWD_LAUNCHES,
            "upsample_argmax": ua.LAUNCHES}


def reset_ce_counts():
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua

    fc.FWD_LAUNCHES = fc.BWD_LAUNCHES = ua.LAUNCHES = 0


def straight_and_resumed(argv, root, die_at, aliases, what):
    """Four runs of ``argv``, each with its CE and eval launches counted
    (reset before, read after): ``straight``, which keeps a copy of its
    own state at the end of epoch ``die_at - 1``; ``branch``, resumed
    from that copy (it runs the straight run's last epochs again from the
    very same state); ``died``, which dies as epoch ``die_at`` starts;
    and ``resumed``, resumed from what ``died`` left. Returns, per run,
    the per-epoch log rows, the launches, the state probes and the final
    states ``aliases``; the kept states; and the states ``died`` left."""
    from dasemanticsegmentationaml_tpu_torch.utils import state_io

    out = {}
    kept_dir = os.path.join(root, "straight", "state_kept")
    for kind in ("straight", "branch", "died", "resumed"):
        save = os.path.join(root, "resumed" if kind == "died" else kind)
        log_path = save + ".jsonl"
        run = argv + ["--save_model_path", save, "--jsonl_log", log_path]
        state_dir = os.path.join(save, "state")
        if kind == "branch":
            run += ["--resume", kept_dir]
        elif kind == "resumed":
            run += ["--resume", state_dir]
        reset_ce_counts()
        t0 = time.perf_counter()
        with state_probes(keep_epoch=(die_at - 1 if kind == "straight"
                                      else None)) as probes:
            res = run_cli(run, die_at if kind == "died" else None)
        secs = time.perf_counter() - t0
        launches = ce_counts()
        with open(log_path) as f:
            rows = [json.loads(line) for line in f]
        log(what, f"{kind}: epochs {[r['epoch'] for r in rows]} in "
            f"{secs:.2f} s host time (set-up, validation and checkpoints "
            f"included); launches {launches}; {res}")
        check((res is None) == (kind == "died"), f"{kind} run: {res}")
        check(launches["upsample_argmax"] > 0,
              "validation did not launch upsample_argmax")
        out[kind] = {"rows": rows, "launches": launches, "probes": probes,
                     "dir": state_dir}
        if kind == "died":
            check(state_io.latest_epoch_marker(state_dir) == die_at - 1,
                  "the dying run's marker")
            out["died_state"] = {a: state_io.restore_train_state(
                state_dir, a) for a in aliases}
            out["died_files"] = sorted(os.listdir(state_dir))
        else:
            out[kind]["states"] = {a: state_io.restore_train_state(
                state_dir, a) for a in aliases}
        if kind == "straight":
            check(state_io.latest_epoch_marker(kept_dir) == die_at - 1,
                  "the straight run's kept marker")
            out["kept"] = {a: state_io.restore_train_state(kept_dir, a)
                           for a in aliases}
    for kind in ("branch", "resumed"):
        restores = out[kind]["probes"]["restores"]
        check([(r[0], r[1]) for r in restores]
              == [(a, die_at) for a in aliases if a.startswith("latest")],
              f"{kind}: restores {restores}")
        check(all(r[3] for r in restores),
              f"{kind}: a restored state is not the saved one")
    return out


def phase_resume(device, card):
    """--resume and --iter_size through the supervised CLI at full width:
    batch 8, 1024x512, fp32 (TF32 off), 3 steps an epoch, checkpoint and
    validation every epoch, every run through one --data_cache (the
    first run builds it), with --iter_size 1 and 2 (straight_and_resumed:
    4 epochs straight, the last resumed from the straight run's own
    epoch-2 state, and a run that dies as epoch 3 starts, resumed; with
    --iter_size 2 the epoch-2 state holds mini-step 1 of an accumulation,
    9 mini-steps). Every restore equals its file bit for bit and starts at
    epoch 3; 3 + 3 CE launches per mini-step in every run. The card's
    backward does not sum in a fixed order, so two runs of the same flags
    part from the second step on: the branch (one epoch from one state)
    is held to the card-step bounds against the straight run (its loss
    within rtol 1e-4, its weights within 0.02 of that epoch's update in
    global l2); the died + resumed run's distance from the straight one is
    printed beside the died run's (the card's own spread over the same
    epochs). The save (device-to-host copy, write) and restore are timed
    and the size of latest.pt printed."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        build_bisenet)

    steps_per_epoch, epochs, die_at = 3, 4, 3
    init = build_bisenet(19, device="cpu", generator=torch.Generator()
                         .manual_seed(0)).state_dict()
    with tempfile.TemporaryDirectory() as root:
        write_cityscapes(root, "train", n=8 * steps_per_epoch, seed=1)
        write_cityscapes(root, "val", n=2)
        for iter_size in (1, 2):
            work = os.path.join(root, f"iter{iter_size}")
            os.makedirs(work)
            argv = ["--root", root, "--batch_size", "8",
                    "--num_epochs", str(epochs),
                    "--max_steps_per_epoch", str(steps_per_epoch),
                    "--iter_size", str(iter_size),
                    "--validation_step", "1", "--checkpoint_step", "1",
                    "--data_cache", os.path.join(root, "cache"),
                    "--dtype", "float32", "--cuda", "0",
                    "--tensorboard", "False"]
            runs = straight_and_resumed(argv, work, die_at, ["latest"],
                                        "resume")
            caches = os.listdir(os.path.join(root, "cache"))
            check(len(caches) == 2, f"--data_cache entries {caches}, "
                  f"expected the train and the val split's")
            for kind, mini_steps in (
                    ("straight", epochs * steps_per_epoch),
                    ("branch", (epochs - die_at) * steps_per_epoch),
                    ("died", die_at * steps_per_epoch),
                    ("resumed", (epochs - die_at) * steps_per_epoch)):
                got = runs[kind]["launches"]
                check(got["fused_ce_fwd"] == 3 * mini_steps
                      and got["fused_ce_bwd"] == 3 * mini_steps,
                      f"--iter_size {iter_size} {kind}: CE launches {got}, "
                      f"expected {3 * mini_steps} each (3 + 3 a mini-step)")
            acc = runs["died_state"]["latest"]["accumulator"]
            if iter_size == 2:
                check(acc is not None and acc["mini_step"] == 1,
                      f"the epoch-2 state's accumulator: {acc}")
            else:
                check(acc is None, "an accumulator without --iter_size")
            loss = {k: [r["loss"] for r in runs[k]["rows"]]
                    for k in ("straight", "branch", "resumed")}
            check([r["epoch"] for r in runs["resumed"]["rows"]]
                  == list(range(epochs))
                  and [r["epoch"] for r in runs["branch"]["rows"]]
                  == list(range(die_at, epochs)), "the resumed epochs")
            final = {k: runs[k]["states"]["latest"]["model"]
                     for k in ("straight", "branch", "resumed")}
            kept = runs["kept"]["latest"]["model"]
            rel_branch = max(abs(a - b) / abs(a) for a, b in zip(
                loss["straight"][die_at:], loss["branch"]))
            l2_branch = update_l2(final["straight"], final["branch"], kept)
            rel_resumed = [abs(a - b) / abs(a) for a, b in zip(
                loss["straight"], loss["resumed"])]
            l2_resumed = update_l2(final["straight"], final["resumed"], init)
            restore = runs["branch"]["probes"]["restores"][0]
            probes = runs["straight"]["probes"]
            size = os.path.getsize(os.path.join(runs["straight"]["dir"],
                                                "latest.pt"))
            log("resume", f"--iter_size {iter_size}: losses straight "
                f"{loss['straight']}, branch {loss['branch']}, died + "
                f"resumed {loss['resumed']} | {card}")
            log("resume", f"--iter_size {iter_size}: branch (epoch "
                f"{die_at} from the straight run's own epoch-{die_at - 1} "
                f"state): bit-identical {same_tree(final['straight'], final['branch'])}, "
                f"loss rel. difference {rel_branch:.3e} (bound 1e-4), "
                f"weights {l2_branch:.3e} of the epoch's update (bound 0.02)")
            log("resume", f"--iter_size {iter_size}: died + resumed against "
                f"straight (the card's spread from the second step on): "
                f"bit-identical {same_tree(final['straight'], final['resumed'])}, "
                f"loss rel. difference by epoch "
                f"{[f'{r:.3e}' for r in rel_resumed]}, final weights "
                f"{l2_resumed:.3e} of the update from the initial weights")
            log("resume", f"--iter_size {iter_size}: restore of 'latest' "
                f"{restore[2] * 1e3:.1f} ms (read + copy into the model and "
                f"optimizer on the card; bit-identical to the file "
                f"{restore[3]}); the straight run's saves: device-to-host "
                f"{[round(t * 1e3, 1) for t in probes['to_host_s']]} ms, "
                f"write {[round(t * 1e3, 1) for t in probes['write_s']]} ms; "
                f"latest.pt {size / 1e6:.3f} MB | {card}")
            check(rel_branch <= 1e-4, f"--iter_size {iter_size}: the "
                  f"branch's loss differs by {rel_branch:.3e}")
            check(l2_branch < 0.02, f"--iter_size {iter_size}: the branch's "
                  f"weights {l2_branch:.3e} of the epoch's update")


def phase_da_resume(device, card):
    """--resume through the DA CLI at full width (FC D, 4-phase step,
    batch 8, 1024x512, fp32, 2 steps an epoch, 3 epochs, through one
    --data_cache; straight_and_resumed with the death as epoch 2
    starts): the dying run leaves
    GTA5_1 / latest and GTA5_1_D1 / latest_D1 states and the marker 1; G,
    D and both optimizers restore bit for bit and start at epoch 2; 2 + 2
    CE launches a step; the branch's epoch 2 (from the straight run's own
    epoch-1 state) within the DA CLI bounds of the straight run's,
    loss_seg rtol 1e-3 and loss_D1 5e-3; the died + resumed run's losses
    printed beside them."""
    steps_per_epoch, epochs, die_at = 2, 3, 2
    names = ["latest", "latest_D1", "GTA5_1", "GTA5_1_D1"]
    with tempfile.TemporaryDirectory() as root:
        gta, cs = os.path.join(root, "gta5"), os.path.join(root, "cityscapes")
        write_gtav(gta, n=8 * steps_per_epoch)
        write_cityscapes(cs, "train", n=8 * steps_per_epoch, seed=1)
        write_cityscapes(cs, "val", n=2)
        argv = ["--domain_adaptation", "True", "--root", cs,
                "--root_source", gta, "--root_target", cs,
                "--depthwise", "False", "--batch_size", "8",
                "--num_epochs", str(epochs),
                "--max_steps_per_epoch", str(steps_per_epoch),
                "--validation_step", "1", "--checkpoint_step", "1",
                "--data_cache", os.path.join(root, "cache"),
                "--dtype", "float32", "--cuda", "0", "--tensorboard", "False"]
        runs = straight_and_resumed(argv, root, die_at, names, "da-resume")
        caches = os.listdir(os.path.join(root, "cache"))
        check(len(caches) == 3, f"--data_cache entries {caches}, expected "
              f"the source's, the target's and the val split's")
        for kind, steps in (("straight", epochs * steps_per_epoch),
                            ("branch", (epochs - die_at) * steps_per_epoch),
                            ("died", die_at * steps_per_epoch),
                            ("resumed", (epochs - die_at) * steps_per_epoch)):
            got = runs[kind]["launches"]
            check(got["fused_ce_fwd"] == 2 * steps
                  and got["fused_ce_bwd"] == 2 * steps,
                  f"DA {kind}: CE launches {got}, expected {2 * steps} each")
        have = runs["died_files"]
        check({f"{n}.pt" for n in names} <= set(have),
              f"the dying run's states: {have}")
        rows = {k: runs[k]["rows"] for k in ("straight", "branch", "resumed")}
        check([r["epoch"] for r in rows["resumed"]] == list(range(epochs))
              and [r["epoch"] for r in rows["branch"]] == [die_at],
              "the resumed epochs")
        rel = {}
        for key in ("loss_seg", "loss_adv"):
            a, b = rows["straight"][die_at][key], rows["branch"][0][key]
            rel[key] = abs(a - b) / abs(a)
        restores = runs["branch"]["probes"]["restores"]
        log("da-resume", f"FC D: the dying run left {have}, marker "
            f"{die_at - 1}; restores (alias, start epoch, ms, bit-identical "
            f"to the file) {[(r[0], r[1], round(r[2] * 1e3, 1), r[3]) for r in restores]}")
        for key in ("loss_seg", "loss_adv"):
            log("da-resume", f"FC D: {key.replace('loss_adv', 'loss_D1')} "
                f"straight {[r[key] for r in rows['straight']]}, branch "
                f"{[r[key] for r in rows['branch']]}, died + resumed "
                f"{[r[key] for r in rows['resumed']]}")
        log("da-resume", f"FC D: the branch's epoch {die_at} against the "
            f"straight run's: loss_seg rel. difference {rel['loss_seg']:.3e} "
            f"(bound 1e-3), loss_D1 {rel['loss_adv']:.3e} (bound 5e-3); "
            f"G, D and optimizer states bit-identical "
            f"{same_tree(runs['straight']['states'], runs['branch']['states'])} "
            f"(died + resumed: "
            f"{same_tree(runs['straight']['states'], runs['resumed']['states'])}) | {card}")
        check(rel["loss_seg"] <= 1e-3 and rel["loss_adv"] <= 5e-3,
              "the resumed DA epoch's losses")


def gxx_finds_image_headers():
    """Whether ``png.h`` and ``jpeglib.h`` are on g++'s include path (the
    preprocessor on a two-line source)."""
    proc = subprocess.run(
        ["g++", "-E", "-x", "c++", "-"], input="#include <png.h>\n"
        "#include <jpeglib.h>\n", capture_output=True, text=True)
    return proc.returncode == 0, proc.stderr.strip().splitlines()[:1]


def write_decode_tree(root, n=16, n_jpeg=4, size=(1024, 2048), seed=5):
    """Cityscapes-sized files: ``n`` pairs of 2048x1024 RGB PNG and label
    PNG in the Cityscapes layout, and ``n_jpeg`` 2048x1024 JPEGs."""
    from PIL import Image

    write_cityscapes(root, "train", n=n, size=size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    jpegs = []
    for i in range(n_jpeg):
        path = os.path.join(root, f"j_{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(
            path, quality=90)
        jpegs.append(path)
    return jpegs


def loader_rate(loader, epochs=3):
    """Images per second of ``loader`` over ``epochs`` shuffled epochs,
    its threads' start included."""
    n = 0
    t0 = time.perf_counter()
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        for images, _ in loader:
            n += images.shape[0]
    return n / (time.perf_counter() - t0)


def phase_loader(card, headers, step_ms_per_image):
    """The host data path on the card's host, at the CLI's 1024x512
    output: 16 Cityscapes-sized pairs (2048x1024 RGB PNG + label PNG) and
    4 JPEGs. The native decoder against PIL, bit for bit (faithful
    resize and not); ms per pair on one thread, native and PIL; the
    Loader's images/s at batch 8 with 1, 4 and 8 workers, native and PIL
    (the GIL overlap); the --data_cache build (s) and its warm read (ms
    per sample); beside the train step's ms per image. Without the image
    headers only PIL is timed; with them a failed build fails the phase."""
    from dasemanticsegmentationaml_tpu_torch.data import cache as dcache
    from dasemanticsegmentationaml_tpu_torch.data import native
    from dasemanticsegmentationaml_tpu_torch.data import transforms_host as th
    from dasemanticsegmentationaml_tpu_torch.data.datasets import CityScapes
    from dasemanticsegmentationaml_tpu_torch.data.pipeline import Loader

    log("loader", f"os.cpu_count() {os.cpu_count()}; image headers on g++'s "
        f"path: {headers}; native decoder: "
        f"{native.library_path() if native.available() else native.unavailable_reason()}")
    if headers:
        check(native.available(), f"the native decoder did not build: "
              f"{native.unavailable_reason()}")

    @contextlib.contextmanager
    def pil_only():
        real = native.decode_resize
        native.decode_resize = lambda *a, **k: None
        try:
            yield
        finally:
            native.decode_resize = real

    paths = ["native", "PIL"] if native.available() else ["PIL"]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        jpegs = write_decode_tree(root)
        ds = CityScapes("train", root, 512, 1024)
        log("loader", f"wrote {len(ds)} pairs + {len(jpegs)} JPEGs at "
            f"2048x1024 (random pixels: PNG compresses them least) in "
            f"{time.perf_counter() - t0:.1f} s (set-up)")
        for faithful in (True, False):
            ds = CityScapes("train", root, 512, 1024,
                            faithful_resize=faithful)
            if native.available():
                got = [ds[i] for i in range(len(ds))]
                got += [(th.load_image(p, (512, 1024), faithful),)
                        for p in jpegs]
                with pil_only():
                    want = [ds[i] for i in range(len(ds))]
                    want += [(th.load_image(p, (512, 1024), faithful),)
                             for p in jpegs]
                bad = [i for i, (g, w) in enumerate(zip(got, want, strict=True))
                       if not all(np.array_equal(a, b) for a, b in zip(g, w))]
                log("loader", f"native against PIL, faithful_resize "
                    f"{faithful}, {got[0][0].shape} images: "
                    f"{len(got) - len(bad)} of {len(got)} samples "
                    f"bit-identical; differing: {bad}")
                check(not bad, "the native decoder differs from PIL")
        timings = {}
        for path in paths:
            with pil_only() if path == "PIL" else contextlib.nullcontext():
                ds[0]  # the first call builds nothing: warm the page cache
                t0 = time.perf_counter()
                for i in range(len(ds)):
                    ds[i]
                per_pair = (time.perf_counter() - t0) * 1e3 / len(ds)
                t0 = time.perf_counter()
                for p in jpegs:
                    th.load_image(p, (512, 1024), True)
                per_jpeg = (time.perf_counter() - t0) * 1e3 / len(jpegs)
                rates = {}
                for workers in (1, 4, 8):
                    loader = Loader(ds, 8, shuffle=True, seed=0,
                                    drop_last=True, num_workers=workers,
                                    pin_memory=True)
                    rates[workers] = loader_rate(loader)
            timings[path] = (per_pair, per_jpeg, rates)
            log("loader", f"{path}: {per_pair:.3f} ms per pair (image + "
                f"label, 2048x1024 -> 1024x512) on one thread, "
                f"{per_jpeg:.3f} ms per JPEG image; Loader, batch 8, "
                f"pinned: " + ", ".join(
                    f"{w} workers {r:.2f} images/s" for w, r in rates.items())
                + f" | {card}")
        cache_root = os.path.join(root, "cache")
        t0 = time.perf_counter()
        cached = dcache.open_or_build(ds, cache_root, num_workers=8)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(len(cached)):
            cached[i]
        read_ms = (time.perf_counter() - t0) * 1e3 / len(cached)
        cache_rate = loader_rate(Loader(cached, 8, shuffle=True, seed=0,
                                        drop_last=True, num_workers=4,
                                        pin_memory=True))
        same = all(np.array_equal(a, b) for i in range(len(ds))
                   for a, b in zip(cached[i], ds[i]))
        log("loader", f"--data_cache: build of {len(ds)} samples with 8 "
            f"workers {build_s:.3f} s; warm read {read_ms:.3f} ms per sample "
            f"(one thread); Loader over it, batch 8, 4 workers "
            f"{cache_rate:.2f} images/s; byte-identical to the decode path: "
            f"{same} | {card}")
        check(same, "the cache differs from the decode path")
        best = max(max(t[2].values()) for t in timings.values())
        log("loader", f"the train step takes {step_ms_per_image:.3f} ms per "
            f"image (bf16, batch 8; {1e3 / step_ms_per_image:.1f} images/s); "
            f"the best decode rate above is {best:.2f} images/s, the cache's "
            f"{cache_rate:.2f}: "
            + ("the loader sets the pace" if best < 1e3 / step_ms_per_image
               else "the card sets the pace") + f" | {card}")


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
    time_da_augmented(device, card, step, labels)
    return ms, peak


def time_da_augmented(device, card, step, labels):
    """The DA step with its source batch prepared from pinned uint8 and
    augmented on the card (each menu), against the same step with the
    batch prepared unaugmented, in turns A B C D D C B A: ms/step (CUDA
    events, the preparation included) and peak memory."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.data.augment import (
        batch_generator)
    from dasemanticsegmentationaml_tpu_torch.data.pipeline import prepare_batch

    rng = np.random.default_rng(7)
    src = torch.from_numpy(rng.integers(0, 256, (8, 1024, 512, 3),
                                        dtype=np.uint8)).pin_memory()
    tgt = torch.from_numpy(rng.integers(0, 256, (8, 1024, 512, 3),
                                        dtype=np.uint8)).pin_memory()
    lab = torch.from_numpy(labels).pin_memory()
    it = iter(range(10**6))

    def one(aug_type):
        gen = (None if aug_type is None
               else batch_generator(0, 0, next(it), device))
        xs, ys = prepare_batch(src, lab, device=device, remap=True,
                               dtype=torch.bfloat16, aug_type=aug_type,
                               generator=gen)
        xt, _ = prepare_batch(tgt, lab, device=device, dtype=torch.bfloat16)
        step(xs, ys, xt)

    order = (None,) + AUG_TYPES
    runs = {}
    for aug_type in order + order[::-1]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ms = cuda_ms(lambda: one(aug_type), 10, warmup=2)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        runs.setdefault(aug_type, []).append((ms, peak))
        log("timing", f"DA step + preparation, bf16, batch 8, 1024x512, "
            f"FC D, source --aug_type {aug_type}: {ms:.3f} ms/step, peak "
            f"memory {peak:.3f} GiB | {card}")
    base = sum(r[0] for r in runs[None]) / 2
    for aug_type in AUG_TYPES:
        ms = sum(r[0] for r in runs[aug_type]) / 2
        log("timing", f"DA step + preparation, --aug_type {aug_type}: mean "
            f"{ms:.3f} ms/step against {base:.3f} unaugmented "
            f"({ms - base:+.3f} ms, {ms / base:.4f}x); peak "
            f"{max(r[1] for r in runs[aug_type]):.3f} against "
            f"{max(r[1] for r in runs[None]):.3f} GiB | {card}")


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


def time_train_prefetch(device, card, n=40):
    """The supervised loop as ``train/supervised.py::train`` runs it: the
    bf16 train step at batch 8, 1024x512 on batches that ``device_prefetch``
    pulls from ``prepare_batch`` of pinned uint8 host batches, with the
    fetch watchdog (its 900 s default: each fetch in its daemon thread)
    and without it (0: fetches in the calling thread), in turns A B B A:
    ms per step by the host's clock over ``n`` steps, the last loss read
    back, and the median ms a step waits in the prefetcher's ``next``
    (the watchdog's thread hop is there)."""
    import statistics

    import torch

    from dasemanticsegmentationaml_tpu_torch.data.pipeline import (
        FETCH_TIMEOUT, device_prefetch, prepare_batch)
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        build_bisenet, trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.train.optim import make_optimizer
    from dasemanticsegmentationaml_tpu_torch.train.supervised import (
        make_train_step)

    model = build_bisenet(19, device=device,
                          generator=torch.Generator().manual_seed(0)).train()
    opt = make_optimizer("sgd", trainable_parameters(model), 0.01,
                         momentum=0.9, weight_decay=1e-4)
    step = make_train_step(model, opt, amp_dtype=torch.bfloat16)
    rng = np.random.default_rng(4)
    host = [(torch.from_numpy(rng.integers(0, 256, (8, 1024, 512, 3),
                                           dtype=np.uint8)).pin_memory(),
             torch.from_numpy(np.where(
                 rng.random((8, 1024, 512)) < 0.05, 255,
                 rng.integers(0, 19, (8, 1024, 512))).astype(
                     np.uint8)).pin_memory()) for _ in range(4)]

    def loop(timeout, steps):
        batches = (prepare_batch(*host[i % len(host)], device=device,
                                 dtype=torch.bfloat16) for i in range(steps))
        waits = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it = device_prefetch(batches, transfer_timeout=timeout, device=device)
        while True:
            t1 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            waits.append(time.perf_counter() - t1)
            loss = step(*batch)
        float(loss)
        return ((time.perf_counter() - t0) * 1e3 / steps,
                statistics.median(waits) * 1e3)

    configs = {"watchdog on": FETCH_TIMEOUT, "watchdog off": 0.0}
    for timeout in configs.values():
        loop(timeout, 3)           # warm-up
    runs = {label: [] for label in configs}
    for label in ("watchdog on", "watchdog off", "watchdog off",
                  "watchdog on"):
        runs[label].append(loop(configs[label], n))
    for label, turns in runs.items():
        mean = sum(ms for ms, _ in turns) / len(turns)
        log("timing", f"supervised loop through device_prefetch, bf16, batch "
            f"8, 1024x512, {n} steps, {label}: mean {mean:.3f} ms/step = "
            f"{8000.0 / mean:.1f} images/s, turns "
            f"{[round(ms, 3) for ms, _ in turns]}; median wait in next() "
            f"{[round(w, 3) for _, w in turns]} ms | {card}")
    return runs


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


def time_steps_against_baseline(device, card, root):
    """The unaugmented train step and DA step (FC D, 4-phase), bf16, batch
    8, 1024x512, each with its batches prepared from pinned uint8 by its
    package's ``prepare_batch``, of the port under ``root`` (A) against
    this checkout's (B), in turns A B B A: ms/step (CUDA events, the
    preparation included) and peak memory. Each side builds its own
    seeded models from its own modules."""
    import importlib

    import torch

    def modules(side):
        def get(name):
            if side == "baseline":
                return baseline_module(root, name)
            return importlib.import_module(
                f"dasemanticsegmentationaml_tpu_torch.{name}")
        return get

    rng = np.random.default_rng(8)
    src = torch.from_numpy(rng.integers(0, 256, (8, 1024, 512, 3),
                                        dtype=np.uint8)).pin_memory()
    tgt = torch.from_numpy(rng.integers(0, 256, (8, 1024, 512, 3),
                                        dtype=np.uint8)).pin_memory()
    lab = torch.from_numpy(rng.integers(0, 35, (8, 1024, 512),
                                        dtype=np.uint8)).pin_memory()
    runs = {}
    for side in ("baseline", "kernel"):
        get = modules(side)
        build_bisenet = get("models.bisenet").build_bisenet
        trainable = get("models.bisenet").trainable_parameters
        make_optimizer = get("train.optim").make_optimizer
        prepare = get("data.pipeline").prepare_batch
        g = build_bisenet(19, device=device,
                          generator=torch.Generator().manual_seed(0)).train()
        d = get("models.discriminator").build_discriminator(
            19, device=device,
            generator=torch.Generator().manual_seed(2)).train()
        train_step = get("train.supervised").make_train_step(
            g, make_optimizer("sgd", trainable(g), 0.01, momentum=0.9,
                              weight_decay=1e-4), amp_dtype=torch.bfloat16)
        da_step = get("train.adversarial").make_da_step(
            g, d, make_optimizer("sgd", trainable(g), 0.01, momentum=0.9,
                                 weight_decay=5e-4),
            make_optimizer("adam", d.parameters(), 1e-3, betas=(0.9, 0.99)),
            lambda_adv=1e-3, amp_dtype=torch.bfloat16)

        def train_one(prepare=prepare, step=train_step):
            step(*prepare(src, lab, device=device, remap=True,
                          dtype=torch.bfloat16))

        def da_one(prepare=prepare, step=da_step):
            xs, ys = prepare(src, lab, device=device, remap=True,
                             dtype=torch.bfloat16)
            xt, _ = prepare(tgt, lab, device=device, dtype=torch.bfloat16)
            step(xs, ys, xt)

        runs[side] = {"train step": train_one, "DA step": da_one}
    for what in ("train step", "DA step"):
        ms = {}
        for side in ("baseline", "kernel", "kernel", "baseline"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t = cuda_ms(runs[side][what], 10, warmup=2)
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            ms.setdefault(side, []).append(t)
            log("baseline", f"{what} + preparation, unaugmented, bf16, batch "
                f"8, 1024x512, {side}: {t:.3f} ms/step, peak memory "
                f"{peak:.3f} GiB | {card}")
        a, b = (sum(ms[k]) / 2 for k in ("baseline", "kernel"))
        log("baseline", f"{what} + preparation, unaugmented: this checkout "
            f"{b:.3f} ms/step against the baseline's {a:.3f} ({b / a:.4f}x;"
            f" turns {ms['baseline'][0]:.3f} {ms['kernel'][0]:.3f} "
            f"{ms['kernel'][1]:.3f} {ms['baseline'][1]:.3f}) | {card}")


def time_dispatch(device, card, root, n=2000):
    """The host's microseconds a call of upsample_argmax and int8_conv at
    a tiny shape (the launch dominates), under inference mode as eval
    calls them: the other version's wrapper (a direct ctypes launch),
    this checkout's wrapper, and this checkout's custom op called through
    the dispatcher (``torch.ops.dseg.*``, as a loaded artifact calls it),
    in turns A B C C B A, each a loop of ``n`` calls and one synchronise.
    The op's row less the wrapper's is the dispatcher's cost a call."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import (
        upsample_argmax as ua)

    base_ua = load_baseline(root, "upsample_argmax")
    base_ic = load_baseline(root, "int8_conv")
    bf16 = torch.bfloat16
    g = torch.Generator().manual_seed(5)
    logits = torch.randn((1, 19, 8, 16), generator=g).to(device, bf16)
    x = torch.randn((1, 32, 8, 8), generator=g).to(device, bf16)
    w8 = torch.randint(-127, 128, (32, 32, 3, 3), generator=g,
                       dtype=torch.int8).to(device)
    packed = ic.pack_weights(w8)
    out_mul = torch.full((32,), 1e-3, device=device)
    bias = torch.zeros(32, device=device)
    inv = torch.tensor(40.0, device=device)
    conv = (w8, packed, out_mul, bias, inv, 1, 1)
    calls = {
        "upsample_argmax": {
            "baseline": lambda: base_ua.upsample_argmax(logits, (32, 64)),
            "wrapper": lambda: ua.upsample_argmax(logits, (32, 64)),
            "op": lambda: torch.ops.dseg.upsample_argmax(logits, 32, 64)},
        "int8_conv": {
            "baseline": lambda: base_ic.int8_conv(x, *conv),
            "wrapper": lambda: ic.int8_conv(x, *conv),
            "op": lambda: torch.ops.dseg.int8_conv(x, *conv, True, bf16)}}

    def host_us(fn):
        with torch.inference_mode():
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    for kernel, fns in calls.items():
        us = {k: [] for k in fns}
        for k in ("baseline", "wrapper", "op", "op", "wrapper", "baseline"):
            us[k].append(host_us(fns[k]))
        mean = {k: sum(v) / len(v) for k, v in us.items()}
        log("baseline", f"{kernel} host us a call at a tiny shape, "
            f"inference mode: baseline wrapper {mean['baseline']:.2f} "
            f"{[round(u, 2) for u in us['baseline']]}, this wrapper "
            f"{mean['wrapper']:.2f} {[round(u, 2) for u in us['wrapper']]},"
            f" the custom op through the dispatcher {mean['op']:.2f} "
            f"{[round(u, 2) for u in us['op']]}: the dispatcher's cost "
            f"{mean['op'] - mean['wrapper']:.2f} us a call | {card}")


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
    cuDNN modules); then the unaugmented train and DA steps with their
    batch preparation, each package's own (``time_steps_against_baseline``);
    then the int8 conv of each version at the 24 shapes of the all filter
    (``time_int8_shapes``); then the host's cost a call of each on-path
    kernel's wrapper and of the custom op (``time_dispatch``); last the
    eval-window phase with the other version's eager loop and its int8
    models, eager and windowed."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_stdc as fs
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic
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
    time_steps_against_baseline(device, card, root)
    time_int8_shapes(device, card, {"baseline": load_baseline(root,
                                                               "int8_conv"),
                                    "kernel": ic})
    time_dispatch(device, card, root)
    phase_eval_window(device, card, root)


#: the parallel phase's global batch (4 rows a rank at world 2), fp32
PARALLEL_SHAPE = (8, 3, 1024, 512)
#: seconds the parallel phase's rank processes may take
PARALLEL_TIMEOUT = 300
#: the BN input the parallel phase times sync BN at: the widest BN input
#: of BiSeNet's stem at batch 8, 1024x512 (ConvX 32 -> 64, stride 4)
BN_TIMED = (8, 64, 256, 128)


def parallel_inputs(seed=21):
    """The global batch: images, labels (rank 1's rows 40% ignore, rank
    0's 5%, so the ranks hold unequal valid counts) and target images."""
    rng = np.random.default_rng(seed)
    b, _, h, w = PARALLEL_SHAPE
    x = rng.standard_normal(PARALLEL_SHAPE).astype(np.float32)
    frac = np.repeat([0.05, 0.40], b // 2)[:, None, None]
    y = np.where(rng.random((b, h, w)) < frac, 255,
                 rng.integers(0, 19, (b, h, w))).astype(np.int32)
    xt = rng.standard_normal(PARALLEL_SHAPE).astype(np.float32)
    return x, y, xt


def seeded_g(device):
    import torch

    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        build_bisenet)

    return build_bisenet(19, device="cpu", generator=torch.Generator(
        ).manual_seed(0)).to(device).train()


def seeded_d(device, kind):
    import torch

    from dasemanticsegmentationaml_tpu_torch.models.discriminator import (
        build_discriminator)

    return build_discriminator(19, *kind, generator=torch.Generator(
        ).manual_seed(2)).to(device).train()


def optimizers(g, d=None):
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.train.optim import make_optimizer

    if d is None:
        return make_optimizer("sgd", trainable_parameters(g), 0.01,
                              momentum=0.9, weight_decay=1e-4)
    return (make_optimizer("sgd", trainable_parameters(g), 0.01,
                           momentum=0.9, weight_decay=5e-4),
            make_optimizer("adam", d.parameters(), 1e-3, betas=(0.9, 0.99)))


def cpu_state(module):
    """The state dict on the CPU in fp32 (a float sum of each parameter
    stands for it where ``sums``)."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def param_sums(module):
    return {k: float(v.detach().double().sum())
            for k, v in module.named_parameters()}


def profiled(fn):
    """(fn(), the profile) with the card's kernels recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof


def ce_launches():
    """The CE kernels' counters (``ce_counts`` without upsample_argmax)."""
    counts = ce_counts()
    return {k: counts[k] for k in ("fused_ce_fwd", "fused_ce_bwd")}


def ce_seen(prof):
    seen = kernel_launches_seen(prof, {"fused_ce_fwd": (("ce_fwd_band",),),
                                       "fused_ce_bwd": (("ce_bwd_band",),)})
    return {name: n for (name, _), n in seen.items()}


def parallel_rank(rank, world, init, out):
    """One of two gloo ranks sharing cuda:0 (parallel phase): the sharded
    train and DA steps on its rows, each under the profiler with the CE
    counters reset before and read after, then timed; and its half of the
    eval batches through eval_counts and allreduce_counts."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import (
        upsample_argmax as ua)
    from dasemanticsegmentationaml_tpu_torch.parallel.distributed import (
        allreduce_counts, destroy, initialize)
    from dasemanticsegmentationaml_tpu_torch.parallel.mesh import (
        make_sharded_da_step, make_sharded_train_step)
    from dasemanticsegmentationaml_tpu_torch.train.evaluate import (
        eval_counts)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    initialize(init, world, rank, backend="gloo", device=device)
    try:
        x, y, xt = parallel_inputs()
        rows = slice(rank * 4, rank * 4 + 4)
        xs, ys, xts = (torch.from_numpy(a[rows]).to(device)
                       for a in (x, y, xt))
        res = {}
        with fp32_math():
            for mode, sync in (("sync", True), ("replica", False)):
                g = seeded_g(device)
                opt = optimizers(g)
                step = make_sharded_train_step(g, opt, num_classes=19,
                                               sync_bn=sync)
                reset_ce_counts()
                loss, prof = profiled(lambda: step(xs, ys))
                res[("train", mode)] = dict(
                    loss=float(loss), state=cpu_state(g),
                    sums=param_sums(g), launches=ce_launches(),
                    seen=ce_seen(prof),
                    ms=cuda_ms(lambda: step(xs, ys), 3, warmup=1))
            for mode, sync, kind in (("sync", True, (True, True)),
                                     ("replica", False, (False, False))):
                g, d = seeded_g(device), seeded_d(device, kind)
                g_opt, d_opt = optimizers(g, d)
                step = make_sharded_da_step(g, d, g_opt, d_opt,
                                            num_classes=19, lambda_adv=1e-3,
                                            sync_bn=sync)
                reset_ce_counts()
                m, prof = profiled(lambda: step(xs, ys, xts))
                res[("da", mode)] = dict(
                    metrics={k: float(v) for k, v in m.items()},
                    g=cpu_state(g), d=cpu_state(d), sums=param_sums(g),
                    launches=ce_launches(), seen=ce_seen(prof),
                    ms=cuda_ms(lambda: step(xs, ys, xts), 2, warmup=1))
        model = seeded_g(device).eval()
        batches = eval_batches(device, keep=range(rank, 16, world))
        ua.LAUNCHES = 0
        hist, correct, total = eval_counts(model, batches, 19,
                                           prepare=lambda b: b,
                                           device=device,
                                           amp_dtype=torch.bfloat16)
        hist, correct, total = allreduce_counts(hist, correct, total)
        res["eval"] = dict(hist=hist.cpu(), correct=int(correct),
                           total=total, launches=ua.LAUNCHES,
                           batches=len(batches))
        torch.save(res, out)
    finally:
        destroy()


def nccl_rank(init, out):
    """World 1 over NCCL (parallel phase): the sync-BN train step through
    the communicator beside the step without a group, allreduce_counts,
    and the BN timings: the port's sync BN, nn.BatchNorm2d,
    torch.nn.SyncBatchNorm (the module; at world 1 it takes the plain
    path) and the library's sync function (the collective path)."""
    import torch
    import torch.distributed as dist
    import torch.nn as nn
    from torch.nn.modules._functions import SyncBatchNorm as LibrarySync

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.parallel.distributed import (
        allreduce_counts)
    from dasemanticsegmentationaml_tpu_torch.parallel.mesh import (
        make_sharded_train_step)
    from dasemanticsegmentationaml_tpu_torch.parallel.sync_bn import (
        convert_sync_batchnorm)
    from dasemanticsegmentationaml_tpu_torch.train.supervised import (
        make_train_step)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=init, world_size=1, rank=0,
                            device_id=device)
    try:
        x, y, _ = parallel_inputs()
        xs, ys = (torch.from_numpy(a[:4]).to(device) for a in (x, y))
        res = {}
        with fp32_math():
            for name in ("nccl", "plain"):
                g = seeded_g(device)
                opt = optimizers(g)
                step = (make_sharded_train_step(g, opt, num_classes=19)
                        if name == "nccl" else make_train_step(g, opt))
                loss = float(step(xs, ys))
                res[name] = dict(loss=loss, state=cpu_state(g))
        hist = torch.arange(19 * 19, device=device,
                            dtype=torch.int64).reshape(19, 19) + 2**33
        correct = torch.tensor(2**35 + 5, device=device)
        h, c, t = allreduce_counts(hist, correct, 2**36 + 1)
        res["counts"] = (torch.equal(h, hist), int(c) == 2**35 + 5,
                         t == 2**36 + 1)
        times = {}
        for dtype in (torch.float32, torch.bfloat16):
            xb = torch.randn(BN_TIMED, device=device, dtype=dtype,
                             requires_grad=True)
            dy = torch.randn_like(xb)
            port = convert_sync_batchnorm(nn.Sequential(nn.BatchNorm2d(
                BN_TIMED[1]))).to(device).train()
            plain = nn.BatchNorm2d(BN_TIMED[1]).to(device).train()
            module = nn.SyncBatchNorm(BN_TIMED[1]).to(device).train()
            lib = nn.BatchNorm2d(BN_TIMED[1]).to(device)

            def library(m=lib):
                return LibrarySync.apply(
                    xb, m.weight, m.bias, m.running_mean, m.running_var,
                    m.eps, m.momentum, dist.group.WORLD, 1)

            for name, fn in (("port", port), ("nn.BatchNorm2d", plain),
                             ("torch.nn.SyncBatchNorm", module),
                             ("library sync function", library)):
                times[(name, str(dtype).split(".")[1])] = cuda_ms(
                    lambda f=fn: f(xb).backward(dy) if f is not library
                    else f().backward(dy), 20)
        res["bn_ms"] = times
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def spawn_parallel(target, args_of, n, timeout=PARALLEL_TIMEOUT):
    """``n`` fresh processes running ``target(*args_of(i, store, out_i))``;
    waits for them under ``timeout`` and returns their saved results. A
    process that fails, or outlives the timeout (it is killed), fails the
    phase."""
    import multiprocessing

    import torch

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"out{i}.pt") for i in range(n)]
        procs = [ctx.Process(target=target, args=args_of(i, store, outs[i]))
                 for i in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        check(not hung, f"processes {hung} still running after "
              f"{timeout} s")
        codes = [p.exitcode for p in procs]
        check(codes == [0] * n, f"exit codes {codes}")
        return [torch.load(o, weights_only=False) for o in outs]


def held_to(ours, ref, init, what, *, g_tol=0.02, rs_tol=0.02,
            leaf_tol=0.1, rs_global=None, skip=()):
    """``ours`` against ``ref`` after one step from ``init`` (fp32 state
    dicts on the CPU), relative to ``ref``'s update (test_train_
    equivalence.py:79-147): the parameters' global l2 within ``g_tol``,
    each within ``leaf_tol`` (None: not held), each running statistic
    within ``rs_tol`` (their global l2 within ``rs_global``), the leaves
    ``ref`` did not move equal. Returns the figures logged."""
    sq = [0.0, 0.0]
    rs = [0.0, 0.0]
    worst = {"leaf": (0.0, ""), "running": (0.0, "")}
    for key, base in init.items():
        if key in skip:
            continue
        base = base.double()
        want, got = ref[key].double(), ours[key].double()
        upd = float((want - base).abs().max())
        if upd < 1e-12:
            check(torch_equal(got, base), f"{what}: {key} moved")
            continue
        err = float((got - want).abs().max()) / upd
        if key.endswith(("running_mean", "running_var")):
            worst["running"] = max(worst["running"], (err, key))
            check(err < rs_tol, f"{what}: running stat {key} {err:.4f}")
            rs[0] += float(((got - want) ** 2).sum())
            rs[1] += float(((want - base) ** 2).sum())
            continue
        sq[0] += float(((got - want) ** 2).sum())
        sq[1] += float(((want - base) ** 2).sum())
        worst["leaf"] = max(worst["leaf"], (err, key))
        if leaf_tol is not None:
            check(err < leaf_tol, f"{what}: {key} {err:.4f} of its update")
    g = math.sqrt(sq[0] / max(sq[1], 1e-30))
    r = math.sqrt(rs[0] / max(rs[1], 1e-30))
    check(g < g_tol, f"{what}: global l2 {g:.4f}")
    if rs_global is not None:
        check(r < rs_global, f"{what}: running statistics global l2 {r:.4f}")
    return (f"{what}: global l2 {g:.5f} (bound {g_tol}), worst leaf "
            f"{worst['leaf'][0]:.4f} at {worst['leaf'][1]}, running "
            f"statistics global l2 {r:.5f}, worst {worst['running'][0]:.4f}")


def torch_equal(a, b):
    import torch

    return bool(torch.equal(a, b))


def per_replica_train_reference(device, x, y):
    """The per-replica train step in one process: two copies of G, each
    through its half with its own BN statistics, the gradients averaged
    into copy 0, one SGD step; (mean loss, copy 0's state, each copy's
    state)."""
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.train.supervised import (
        make_supervised_loss)

    gs = [seeded_g(device) for _ in range(2)]
    opt = optimizers(gs[0])
    losses = []
    for r, g in enumerate(gs):
        loss = make_supervised_loss(g)(x[r * 4:r * 4 + 4], y[r * 4:r * 4 + 4])
        loss.backward()
        losses.append(float(loss))
    average_into_first([trainable_parameters(g) for g in gs])
    opt.step()
    copy_params(gs)
    return sum(losses) / 2, [cpu_state(g) for g in gs]


def average_into_first(param_lists):
    """Copy 0's gradients become the mean over the copies."""
    for ps in zip(*param_lists):
        if ps[0].grad is not None:
            ps[0].grad = sum(p.grad for p in ps) / len(ps)


def copy_params(models):
    import torch

    with torch.no_grad():
        for ps in zip(*(list(m.parameters()) for m in models)):
            for p in ps[1:]:
                p.copy_(ps[0])


def per_replica_da_reference(device, x, y, xt):
    """The per-replica 4-phase DA step (FC D, d_head 0, lambda 1e-3) in one
    process: two copies of G and of D, each phase's forwards on each
    copy's half (its own BN statistics), that phase's gradients averaged
    into copy 0, its optimizer step, its parameters copied to copy 1
    (JAX mesh.py:303-332 with adversarial.py:108-110's pmean); returns
    (the mean metrics, G copies' states, D copy 0's state)."""
    import torch
    import torch.nn.functional as F

    from dasemanticsegmentationaml_tpu_torch.ops.cuda.fused_ce import (
        cross_entropy_upsampled)
    from dasemanticsegmentationaml_tpu_torch.ops.losses import (
        bce_with_logits, cross_entropy_ignore)
    from dasemanticsegmentationaml_tpu_torch.ops.resize import (
        resize_bilinear_align_corners)
    from dasemanticsegmentationaml_tpu_torch.train.adversarial import _frozen

    gs = [seeded_g(device) for _ in range(2)]
    ds = [seeded_d(device, (False, False)) for _ in range(2)]
    g_opt, d_opt = optimizers(gs[0], ds[0])
    halves = [slice(0, 4), slice(4, 8)]
    hw = tuple(x.shape[2:])
    for m in gs + ds:
        m.zero_grad(set_to_none=False)

    def mean_step(models, opt):
        average_into_first([list(m.parameters()) for m in models])
        opt.step()
        copy_params(models)

    metrics = {"loss": 0.0, "loss_D1": 0.0, "src": 0.0, "tgt": 0.0}
    ups = []
    for g, h in zip(gs, halves):
        feats = g.features(x[h])
        up = resize_bilinear_align_corners(feats[0], hw)
        loss = (cross_entropy_ignore(up, y[h])
                + cross_entropy_upsampled(feats[1].contiguous(), y[h], hw)
                + cross_entropy_upsampled(feats[2].contiguous(), y[h], hw))
        loss.backward()
        metrics["loss"] += float(loss) / 2
        ups.append(up)
    mean_step(gs, g_opt)
    upts = []
    for g, d, h in zip(gs, ds, halves):
        g.zero_grad(set_to_none=False)
        up = resize_bilinear_align_corners(g.features(xt[h])[0], hw)
        with _frozen(d):
            loss = bce_with_logits(d(F.softmax(up, dim=1)), 0.0) * 1e-3
            loss.backward()
        metrics["loss_D1"] += float(loss) / 2
        upts.append(up)
    mean_step(gs, g_opt)
    for key, maps, label in (("src", ups, 0.0), ("tgt", upts, 1.0)):
        for d, up in zip(ds, maps):
            d.zero_grad(set_to_none=False)
            loss = bce_with_logits(d(F.softmax(up.detach(), dim=1)), label)
            loss.backward()
            metrics[key] += float(loss) / 2
        mean_step(ds, d_opt)
    metrics = {"loss": metrics["loss"], "loss_D1": metrics["loss_D1"],
               "loss_G": metrics["loss"] + metrics["loss_D1"],
               "loss_adv": metrics["src"] + metrics["tgt"]}
    torch.cuda.synchronize()
    return metrics, [cpu_state(g) for g in gs], cpu_state(ds[0])


def phase_parallel(device, card):
    """Data parallelism across ranks (parallel/): two gloo ranks sharing
    cuda:0 (NCCL refuses two ranks on one card) run one fp32 sharded train
    step (TF32 off) at 2 x 4 x 1024 x 512 with --sync_bn True and False,
    and one DA step the same way (sync: DW+BN D; per replica: FC D), each
    held against the single-process reference on this card: sync mode
    against the plain step on the global batch (loss rtol 1e-4, PERF.md
    §2's card-row bounds: global l2 < 0.02 of the update, each leaf <
    0.1, running statistics < 0.02; DA: the four losses rtol 1e-4, G the
    same, D global l2 < 0.25 without the BN-fed conv biases, running
    statistics 0.3 a leaf and 0.05 global), per-replica mode against one
    process running each half through its own copy of the model and
    averaging the gradients (rank r's statistics against copy r's). The
    ranks' parameters are equal bit for bit; each rank launches 3 + 3 CE
    kernels a train step and 2 + 2 a DA step, by its counters and by its
    profile. Then the int64 counts of two ranks each on half of 16
    prepared bf16 batches of 8 equal one process's over all of them, bit
    for bit; and at world 1 over NCCL one sync-BN train step against the
    step without a group (the same bounds), allreduce_counts through the
    communicator, and sync BN timed against nn.BatchNorm2d and
    torch.nn.SyncBatchNorm. Returns the kernels' launches in the ranks."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.train.adversarial import (
        make_da_step)
    from dasemanticsegmentationaml_tpu_torch.train.evaluate import (
        eval_counts)
    from dasemanticsegmentationaml_tpu_torch.train.supervised import (
        make_train_step)

    t0 = time.perf_counter()
    ranks = spawn_parallel(parallel_rank, lambda i, store, out:
                           (i, 2, store, out), 2)
    t_ranks = time.perf_counter() - t0
    x, y, xt = (torch.from_numpy(a).to(device) for a in parallel_inputs())
    init = cpu_state(seeded_g("cpu"))
    launches = {"fused_ce_fwd": 0, "fused_ce_bwd": 0, "upsample_argmax": 0}
    with fp32_math():
        for mode in ("sync", "replica"):
            got = [r[("train", mode)] for r in ranks]
            check(got[0]["sums"] == got[1]["sums"],
                  f"train {mode}: the ranks' parameters differ")
            for r, g in enumerate(got):
                check(g["launches"] == {"fused_ce_fwd": 3, "fused_ce_bwd": 3}
                      and g["seen"] == g["launches"],
                      f"train {mode} rank {r}: CE launches {g['launches']}, "
                      f"profile {g['seen']}")
                for name, n in g["launches"].items():
                    launches[name] += n
            if mode == "sync":
                g = seeded_g(device)
                want = float(make_train_step(g, optimizers(g))(x, y))
                refs = [cpu_state(g)] * 2
            else:
                want, refs = per_replica_train_reference(device, x, y)
            check(abs(got[0]["loss"] - want) <= 1e-4 * abs(want),
                  f"train {mode}: loss {got[0]['loss']} against {want}")
            log("parallel", f"train {mode}: loss {got[0]['loss']:.7f} "
                f"against one process's {want:.7f}; "
                + held_to(got[0]["state"], refs[0], init, "rank 0"))
            log("parallel", held_to(
                got[1]["state"], refs[1], init, f"train {mode} rank 1"))
        d_init = {kind: cpu_state(seeded_d("cpu", kind))
                  for kind in ((True, True), (False, False))}
        bn_fed = {f"conv{i}_{s}.bias" for i in range(1, 5) for s in "dp"}
        for mode, kind in (("sync", (True, True)), ("replica", (False, False))):
            got = [r[("da", mode)] for r in ranks]
            check(got[0]["sums"] == got[1]["sums"]
                  and got[0]["metrics"] == got[1]["metrics"],
                  f"da {mode}: the ranks differ")
            for r, g in enumerate(got):
                check(g["launches"] == {"fused_ce_fwd": 2, "fused_ce_bwd": 2}
                      and g["seen"] == g["launches"],
                      f"da {mode} rank {r}: CE launches {g['launches']}, "
                      f"profile {g['seen']}")
                for name, n in g["launches"].items():
                    launches[name] += n
            if mode == "sync":
                g, d = seeded_g(device), seeded_d(device, kind)
                m = make_da_step(g, d, *optimizers(g, d),
                                 lambda_adv=1e-3)(x, y, xt)
                want = {k: float(v) for k, v in m.items()}
                g_refs, d_ref = [cpu_state(g)] * 2, cpu_state(d)
            else:
                want, g_refs, d_ref = per_replica_da_reference(device, x, y,
                                                               xt)
            for key, value in want.items():
                check(abs(got[0]["metrics"][key] - value)
                      <= 1e-4 * abs(value),
                      f"da {mode} {key}: {got[0]['metrics'][key]} against "
                      f"{value}")
            log("parallel", f"da {mode}: {got[0]['metrics']} against one "
                f"process's {want}; " + held_to(
                    got[0]["g"], g_refs[0], init, "G", rs_tol=0.3,
                    rs_global=0.05) + "; " + held_to(
                    got[0]["d"], d_ref, d_init[kind], "D", g_tol=0.25,
                    leaf_tol=None, rs_tol=0.3, rs_global=0.05,
                    skip=bn_fed if kind == (True, True) else ()))
            log("parallel", held_to(
                got[1]["g"], g_refs[1], init, f"da {mode} rank 1's G",
                rs_tol=0.3, rs_global=0.05))
    g = seeded_g(device).eval()
    hist, correct, total = eval_counts(g, eval_batches(device), 19,
                                       prepare=lambda b: b, device=device,
                                       amp_dtype=torch.bfloat16)
    for r, rank in enumerate(ranks):
        ev = rank["eval"]
        check(torch.equal(ev["hist"], hist.cpu())
              and (ev["correct"], ev["total"]) == (int(correct), total),
              f"rank {r}: sharded eval counts differ from one process's")
        check(ev["launches"] == ev["batches"] == 8,
              f"rank {r}: {ev['launches']} upsample_argmax launches for "
              f"{ev['batches']} batches")
        launches["upsample_argmax"] += ev["launches"]
    log("parallel", f"sharded eval: the two ranks' int64 counts over 8 + 8 "
        f"batches equal one process's over 16, bit for bit ({total} pixels)")
    t1 = time.perf_counter()
    (nccl,) = spawn_parallel(nccl_rank, lambda i, store, out: (store, out), 1)
    t_nccl = time.perf_counter() - t1
    check(abs(nccl["nccl"]["loss"] - nccl["plain"]["loss"])
          <= 1e-4 * abs(nccl["plain"]["loss"]), f"NCCL world 1: loss "
          f"{nccl['nccl']['loss']} against {nccl['plain']['loss']}")
    log("parallel", "NCCL world 1: sync-BN step against the step without a "
        f"group: loss {nccl['nccl']['loss']:.7f} against "
        f"{nccl['plain']['loss']:.7f}; " + held_to(
            nccl["nccl"]["state"], nccl["plain"]["state"], init, "state"))
    check(all(nccl["counts"]), f"allreduce_counts over NCCL: {nccl['counts']}")
    for mode in ("sync", "replica"):
        log("parallel", f"{card} | two gloo ranks on one card, fp32, 4 rows "
            f"a rank at 1024x512: train step {mode} "
            f"{ranks[0][('train', mode)]['ms']:.2f} ms, DA step {mode} "
            f"{ranks[0][('da', mode)]['ms']:.2f} ms (rank 0, CUDA events)")
    for (name, dtype), ms in nccl["bn_ms"].items():
        log("parallel", f"{card} | BN forward + backward at {BN_TIMED} "
            f"{dtype}, world 1 over NCCL: {name} {ms:.4f} ms")
    log("parallel", f"passed: ranks {t_ranks:.1f} s, NCCL {t_nccl:.1f} s, "
        f"in all {time.perf_counter() - t0:.1f} s; launches in the ranks "
        f"{launches}")
    return launches


#: the spatial phase's global batch (fp32): 4 images at 1024x512 (height
#: 1024, so 16 rows a rank at stride 32 over two bands)
SPATIAL_SHAPE = (4, 3, 1024, 512)
#: seconds the spatial phase's rank processes may take
SPATIAL_TIMEOUT = 600
#: eval batches the spatial phase also runs in fp32 (TF32 off)
SPATIAL_FP32_BATCHES = 4
#: how far the bands' bf16 labels may agree less with one process's than
#: one process's own do when each batch runs as two of 4 (0.9843 against
#: the bands' 0.9828 on an H100: bf16 rounding of other conv shapes)
SPATIAL_BF16_SLACK = 0.005


def spatial_inputs(seed=23):
    """The spatial phase's global batch: images, labels (the first two 5%
    ignore, the last two 40%) and target images."""
    rng = np.random.default_rng(seed)
    b, _, h, w = SPATIAL_SHAPE
    x = rng.standard_normal(SPATIAL_SHAPE).astype(np.float32)
    frac = np.repeat([0.05, 0.40], b // 2)[:, None, None]
    y = np.where(rng.random((b, h, w)) < frac, 255,
                 rng.integers(0, 19, (b, h, w))).astype(np.int32)
    xt = rng.standard_normal(SPATIAL_SHAPE).astype(np.float32)
    return x, y, xt


def spatial_gather(mesh, t):
    """The whole tensor of the bands ``t`` of the spatial group (dim 2 of
    (B, C, H, W), dim 1 of (B, H, W)), on ``t``'s device."""
    import torch
    import torch.distributed as dist

    on = t.detach().to(mesh.device).contiguous()
    parts = [torch.empty_like(on) for _ in range(mesh.spatial_size)]
    dist.all_gather(parts, on, group=mesh.spatial_group)
    return torch.cat(parts, 2 if t.dim() == 4 else 1).to(t.device)


def spatial_windows(model, mesh, xs, ys):
    """On this rank's band: the eval model's main head (fp32 and bf16
    autocast) through the windowed upsample_argmax against the same rows
    of the full kernel on the gathered logits, bit for bit; the windowed
    CE kernel (fp32) against its windowed plain version, and the bands'
    shares summed against the full kernel's loss."""
    import torch
    import torch.distributed as dist

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua

    out = {}
    hb, w = ys.shape[1], ys.shape[2]
    s = mesh.spatial_index
    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad(), mesh.banded(), (
                torch.autocast("cuda", dtype=dtype)
                if dtype == torch.bfloat16 else contextlib.nullcontext()):
            f = model.features(xs)[0].contiguous()
            win, window = mesh.window(f, hb)
        full = ua.upsample_argmax(spatial_gather(mesh, f), (hb * 2, w))
        got = ua.upsample_argmax(win, (hb, w), window=window)
        torch.cuda.synchronize()
        h_band = f.shape[2]
        out[("argmax", str(dtype))] = (
            bool(torch.equal(got, full[:, window.y0:window.y1])),
            window.base < s * h_band
            or window.base + win.shape[2] > (s + 1) * h_band)
        if dtype == torch.float32:
            n_valid = mesh.valid_count(ys, 19)
            value = {}
            for name, fn in (("kernel", fc.cross_entropy_upsampled),
                             ("plain", fc.cross_entropy_upsampled_reference)):
                x = win.detach().requires_grad_()
                share = fn(x, ys, (hb, w), 255, window=window,
                           n_valid=n_valid)
                (grad,) = torch.autograd.grad(share, x)
                value[name] = (share.detach(), grad)
            (k, kg), (p, pg) = value["kernel"], value["plain"]
            total = k.clone().reshape(1).to(mesh.device)
            dist.all_reduce(total, group=mesh.spatial_group)
            whole = fc.cross_entropy_upsampled(
                spatial_gather(mesh, f), spatial_gather(mesh, ys),
                (hb * 2, w))
            out["ce"] = dict(
                loss_err=abs(k.item() - p.item()) / abs(p.item()),
                grad_err=((kg - pg).abs().max()
                          / pg.abs().max()).item(),
                sum_err=abs(total.item() - whole.item()) / abs(whole.item()))
    return out


def spatial_rank(rank, world, init, out, device="cuda:0"):
    """One of two gloo ranks sharing cuda:0 as a 1 x 2 spatial mesh
    (spatial phase): the sync train step and the DA steps (DW+BN D, FC D)
    on its band of the global batch, each under the profiler with the CE
    counters reset before and read after, then timed, with its halo
    exchanges and peak memory; the windowed kernels on its band; and its
    band of 16 prepared bf16 eval batches of 8 through eval_counts and
    allreduce_counts, with its predictions."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import (
        upsample_argmax as ua)
    from dasemanticsegmentationaml_tpu_torch.parallel.distributed import (
        allreduce_counts, destroy, initialize)
    from dasemanticsegmentationaml_tpu_torch.parallel.mesh import (
        make_sharded_da_step, make_sharded_train_step)
    from dasemanticsegmentationaml_tpu_torch.parallel.spatial import (
        create_mesh_spatial)
    from dasemanticsegmentationaml_tpu_torch.train.evaluate import (
        eval_counts, predict)

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize(init, world, rank, backend="gloo", device=device)
    try:
        mesh = create_mesh_spatial(1, world)
        x, y, xt = spatial_inputs()
        xs, ys, xts = mesh.shard(*(torch.from_numpy(a).to(device)
                                   for a in (x, y, xt)))
        res = {}

        def run(key, step, args, iters):
            reset_ce_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, prof = profiled(lambda: step(*args))
            launches = ce_launches()
            peak = torch.cuda.max_memory_allocated()
            n0, t0 = mesh.exchanges, mesh.exchange_seconds
            ms = cuda_ms(lambda: step(*args), iters, warmup=1)
            calls = iters + 1
            res[key].update(
                launches=launches, seen=ce_seen(prof), peak=peak, ms=ms,
                exchanges=(mesh.exchanges - n0) / calls,
                exchange_ms=(mesh.exchange_seconds - t0) * 1e3 / calls)

        with fp32_math():
            # each step's first call is held against one process; the
            # calls after it are profiled and timed
            g = seeded_g(device)
            step = make_sharded_train_step(g, optimizers(g), num_classes=19,
                                           spatial=mesh)
            res["train"] = dict(loss=float(step(xs, ys)), state=cpu_state(g),
                                sums=param_sums(g))
            run("train", step, (xs, ys), 3)
            for name, kind in (("dwbn", (True, True)),
                               ("fc", (False, False))):
                g, d = seeded_g(device), seeded_d(device, kind)
                step = make_sharded_da_step(g, d, *optimizers(g, d),
                                            num_classes=19, lambda_adv=1e-3,
                                            spatial=mesh)
                m = step(xs, ys, xts)
                res[("da", name)] = dict(
                    metrics={k: float(v) for k, v in m.items()},
                    g=cpu_state(g), d=cpu_state(d), sums=param_sums(g),
                    dsums=param_sums(d))
                run(("da", name), step, (xs, ys, xts), 2)
            model = mesh.convert(seeded_g(device).eval())
            res["windows"] = spatial_windows(model, mesh, xs, ys)
        batches = eval_batches(device)
        ua.LAUNCHES = 0
        hist, correct, total = eval_counts(model, batches, 19,
                                           prepare=lambda b: b,
                                           device=device,
                                           amp_dtype=torch.bfloat16,
                                           spatial=mesh)
        launches = ua.LAUNCHES
        hist, correct, total = allreduce_counts(hist, correct, total)
        ua.LAUNCHES = 0
        preds, prof = profiled(lambda: [
            predict(model, mesh.shard(images)[0], True, torch.bfloat16,
                    spatial=mesh).to(torch.uint8).cpu()
            for images, _ in batches])
        seen = kernel_launches_seen(prof, {"upsample_argmax": (
            ("upsample_argmax_band_kernel",),)})
        res["eval"] = dict(hist=hist.cpu(), correct=int(correct),
                           total=total, launches=launches,
                           predict_launches=ua.LAUNCHES,
                           seen=sum(seen.values()), batches=len(batches),
                           preds=torch.stack(preds))
        # fp32 (TF32 off) on the first SPATIAL_FP32_BATCHES of them
        with fp32_math():
            fp32 = [(images.float(), labels) for images, labels
                    in batches[:SPATIAL_FP32_BATCHES]]
            hist, correct, total = allreduce_counts(*eval_counts(
                model, fp32, 19, prepare=lambda b: b, device=device,
                spatial=mesh))
            preds = [predict(model, mesh.shard(images)[0], True,
                             spatial=mesh).to(torch.uint8).cpu()
                     for images, _ in fp32]
        res["eval_fp32"] = dict(hist=hist.cpu(), total=total,
                                preds=torch.stack(preds))
        torch.save(res, out)
    finally:
        destroy()


def phase_spatial(device, card):
    """The height-sharded mesh (parallel/spatial.py): two gloo ranks share
    cuda:0 as data 1 x spatial 2, each on 512 of the 1024 rows of a global
    batch of 4 (fp32, TF32 off, full-width BiSeNet-STDC813): one sync-BN
    train step and one DA step with the DW+BN D and one with the FC D,
    each held against one process on the card on the global batch (train:
    loss rtol 1e-4, global l2 < 0.02 of the update, each leaf < 0.1,
    statistics < 0.02; DA: the four losses rtol 1e-4, G the same with
    statistics 0.3 a leaf and 0.05 global, D global l2 < 0.25 without the
    BN-fed biases); the ranks' parameters equal bit for bit; 3 + 3 CE
    launches a rank a train step and 2 + 2 a DA step by the counters and
    by the profile. The windowed kernels on each rank's band: upsample_
    argmax against the same rows of the full kernel (fp32, bf16, bit for
    bit; a band's taps reach past its logits rows), the CE kernels against
    their windowed plain version (loss 1e-5, gradient 1e-4 of its max)
    and the bands' shares summed against the full kernel's loss (1e-5).
    Eval: 16 prepared bf16 batches of 8 at 512x1024 in two bands against
    one process: mIoU |Δ| <= 1e-3; labels equal on no fewer pixels than
    one process's own labels with each batch run as two of 4 (bf16
    rounding of other conv shapes: cuDNN takes other algorithms) less
    ``SPATIAL_BF16_SLACK``; the first 4 batches in fp32 (TF32 off): mIoU
    |Δ| <= 1e-3, labels equal on >= 0.999 of pixels; 1 upsample_argmax a
    rank a batch by the counter and the profile. Logs step ms a rank,
    the halo exchanges a step (count, host ms) and peak memory a rank
    against one process. Returns the kernels' launches in the ranks."""
    import torch

    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.ops.metrics import per_class_iou
    from dasemanticsegmentationaml_tpu_torch.train.adversarial import (
        make_da_step)
    from dasemanticsegmentationaml_tpu_torch.train.evaluate import (
        eval_counts, predict)
    from dasemanticsegmentationaml_tpu_torch.train.supervised import (
        make_train_step)

    t0 = time.perf_counter()
    ranks = spawn_parallel(spatial_rank, lambda i, store, out:
                           (i, 2, store, out, str(device)), 2,
                           timeout=SPATIAL_TIMEOUT)
    t_ranks = time.perf_counter() - t0
    x, y, xt = (torch.from_numpy(a).to(device) for a in spatial_inputs())
    init = cpu_state(seeded_g("cpu"))
    launches = {"fused_ce_fwd": 0, "fused_ce_bwd": 0, "upsample_argmax": 0}
    peaks = {}
    with fp32_math():
        got = [r["train"] for r in ranks]
        check(got[0]["sums"] == got[1]["sums"],
              "spatial train: the ranks' parameters differ")
        for r, g in enumerate(got):
            check(g["launches"] == {"fused_ce_fwd": 3, "fused_ce_bwd": 3}
                  and g["seen"] == g["launches"],
                  f"spatial train rank {r}: CE launches {g['launches']}, "
                  f"profile {g['seen']}")
            for name, n in g["launches"].items():
                launches[name] += n
        g = seeded_g(device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want = float(make_train_step(g, optimizers(g))(x, y))
        peaks["train"] = torch.cuda.max_memory_allocated()
        check(abs(got[0]["loss"] - want) <= 1e-4 * abs(want),
              f"spatial train: loss {got[0]['loss']} against {want}")
        log("spatial", f"train: loss {got[0]['loss']:.7f} against one "
            f"process's {want:.7f}; " + held_to(got[0]["state"],
                                                cpu_state(g), init, "rank 0"))
        bn_fed = {f"conv{i}_{s}.bias" for i in range(1, 5) for s in "dp"}
        for name, kind in (("dwbn", (True, True)), ("fc", (False, False))):
            got = [r[("da", name)] for r in ranks]
            check(got[0]["sums"] == got[1]["sums"]
                  and got[0]["dsums"] == got[1]["dsums"]
                  and got[0]["metrics"] == got[1]["metrics"],
                  f"spatial da {name}: the ranks differ")
            for r, g in enumerate(got):
                check(g["launches"] == {"fused_ce_fwd": 2, "fused_ce_bwd": 2}
                      and g["seen"] == g["launches"],
                      f"spatial da {name} rank {r}: CE launches "
                      f"{g['launches']}, profile {g['seen']}")
                for key, n in g["launches"].items():
                    launches[key] += n
            g, d = seeded_g(device), seeded_d(device, kind)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            m = make_da_step(g, d, *optimizers(g, d), lambda_adv=1e-3)(
                x, y, xt)
            want = {k: float(v) for k, v in m.items()}
            peaks[("da", name)] = torch.cuda.max_memory_allocated()
            for key, value in want.items():
                check(abs(got[0]["metrics"][key] - value) <= 1e-4 * abs(value),
                      f"spatial da {name} {key}: {got[0]['metrics'][key]} "
                      f"against {value}")
            log("spatial", f"da {name}: {got[0]['metrics']} against one "
                f"process's {want}; " + held_to(
                    got[0]["g"], cpu_state(g), init, "G", rs_tol=0.3,
                    rs_global=0.05) + "; " + held_to(
                    got[0]["d"], cpu_state(d), cpu_state(seeded_d("cpu", kind)),
                    "D", g_tol=0.25, leaf_tol=None, rs_tol=0.3,
                    rs_global=0.05, skip=bn_fed if kind == (True, True)
                    else ()))
    for r, rank in enumerate(ranks):
        w = rank["windows"]
        for dtype in ("torch.float32", "torch.bfloat16"):
            equal, crossing = w[("argmax", dtype)]
            check(equal, f"rank {r}: the windowed upsample_argmax differs "
                  f"from the full kernel's rows ({dtype})")
            check(crossing, f"rank {r}: the window's taps stayed inside "
                  f"its band ({dtype})")
        ce = w["ce"]
        check(ce["loss_err"] <= 1e-5 and ce["grad_err"] <= 1e-4
              and ce["sum_err"] <= 1e-5,
              f"rank {r}: the windowed CE kernel: {ce}")
        log("spatial", f"rank {r}: windowed upsample_argmax equals the full "
            f"kernel's rows (fp32, bf16; taps past the band's logits "
            f"rows); windowed CE against its plain version: loss "
            f"{ce['loss_err']:.2e}, gradient {ce['grad_err']:.2e} of its "
            f"max; the shares' sum against the full kernel "
            f"{ce['sum_err']:.2e}")
    model = seeded_g(device).eval()
    batches = eval_batches(device)
    hist, correct, total = eval_counts(model, batches, 19,
                                       prepare=lambda b: b, device=device,
                                       amp_dtype=torch.bfloat16)

    def labels_of(batches, amp_dtype, parts=1):
        """One process's labels, each batch in ``parts`` pieces."""
        return torch.stack([torch.cat([
            predict(model, piece, True, amp_dtype).to(torch.uint8).cpu()
            for piece in images.chunk(parts)]) for images, _ in batches])

    preds = labels_of(batches, torch.bfloat16)
    # the yardstick: one process's own labels when only the batch's conv
    # shapes change (each batch as two of 4), nothing banded
    yard = float((labels_of(batches, torch.bfloat16, 2) == preds)
                 .float().mean())
    miou = float(per_class_iou(hist.cpu()).mean())
    ev = [rank["eval"] for rank in ranks]
    got_miou = float(per_class_iou(ev[0]["hist"]).mean())
    same = float((torch.cat([e["preds"] for e in ev], 2) == preds)
                 .float().mean())
    check(abs(got_miou - miou) <= 1e-3 and ev[0]["total"] == total,
          f"spatial eval: mIoU {got_miou} against {miou}")
    # in bf16 another conv shape flips labels of these seeded weights in
    # one process too: the bands may not flip more than that, with half a
    # percent to spare (fp32 is held to 0.999 below)
    check(same >= yard - SPATIAL_BF16_SLACK,
          f"spatial eval: labels equal on {same}, one process with other "
          f"conv shapes {yard}")
    with fp32_math():
        fp32 = [(images.float(), labels) for images, labels
                in batches[:SPATIAL_FP32_BATCHES]]
        hist32, _, total32 = eval_counts(model, fp32, 19,
                                         prepare=lambda b: b, device=device)
        preds32 = labels_of(fp32, None)
    ev32 = [rank["eval_fp32"] for rank in ranks]
    miou32 = float(per_class_iou(hist32.cpu()).mean())
    got_miou32 = float(per_class_iou(ev32[0]["hist"]).mean())
    same32 = float((torch.cat([e["preds"] for e in ev32], 2) == preds32)
                   .float().mean())
    check(abs(got_miou32 - miou32) <= 1e-3 and ev32[0]["total"] == total32,
          f"spatial eval fp32: mIoU {got_miou32} against {miou32}")
    check(same32 >= 0.999, f"spatial eval fp32: labels equal on {same32}")
    log("spatial", f"eval fp32 (TF32 off), {SPATIAL_FP32_BATCHES} batches: "
        f"mIoU {got_miou32:.6f} against one process's {miou32:.6f}, labels "
        f"equal on {same32:.6f}")
    for r, e in enumerate(ev):
        check(e["launches"] == e["predict_launches"] == e["seen"]
              == e["batches"] == 16,
              f"rank {r}: {e['launches']} / {e['predict_launches']} "
              f"upsample_argmax launches (profile {e['seen']}) for "
              f"{e['batches']} batches")
        launches["upsample_argmax"] += e["launches"]
    log("spatial", f"eval: two bands' int64 counts over 16 bf16 batches of "
        f"8: mIoU {got_miou:.6f} against one process's {miou:.6f}, "
        f"precision {ev[0]['correct'] / total:.6f} against "
        f"{int(correct) / total:.6f}; labels equal on {same:.6f} (one "
        f"process's own labels with each batch as two of 4: {yard:.6f})")
    for key, name in (("train", "train step"), (("da", "dwbn"),
                                                "DA step (DW+BN D)"),
                      (("da", "fc"), "DA step (FC D)")):
        rk = ranks[0][key]
        log("spatial", f"{card} | two gloo ranks on one card, fp32, 512 of "
            f"1024 rows a rank, batch 4: {name} {rk['ms']:.2f} ms a rank "
            f"(rank 0, CUDA events); {rk['exchanges']:.0f} halo exchanges "
            f"a step, {rk['exchange_ms']:.2f} host ms in them; peak "
            f"{rk['peak'] / 2**30:.3f} GiB a rank against one process's "
            f"{peaks[key] / 2**30:.3f} GiB")
    log("spatial", f"passed: ranks {t_ranks:.1f} s, in all "
        f"{time.perf_counter() - t0:.1f} s; launches in the ranks "
        f"{launches}")
    return launches


#: the mesh-serve phase: its ranks' time limit, the calibration batches
#: of its int8 model, the int8 shapes held in bands (conv_out.conv and the
#: stem, INT8_CASES), the batches of the height-sharded artifact, the
#: PNGs its runner serves
MESH_TIMEOUT = 900
MESH_CALIB_BATCHES = 2
INT8_BAND_CASES = (INT8_CASES[0], INT8_CASES[1])
MESH_SPATIAL_BATCHES = (1, 8)
MESH_SERVE_IMAGES = 8


def mesh_counts():
    """The launch counters of the mesh-serve phase's kernels."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import (
        upsample_argmax as ua)

    return {"upsample_argmax": ua.LAUNCHES,
            "upsample_argmax_window": ua.WINDOW_LAUNCHES,
            "int8_conv": ic.LAUNCHES}


def mesh_seen(prof):
    """The profile's upsample_argmax and int8_conv calls (its GEMMs: one a
    call, beside one prologue)."""
    seen = kernel_launches_seen(prof, INT8_KERNEL_NAMES)
    return {"upsample_argmax": seen[("upsample_argmax",
                                     ("upsample_argmax_band_kernel",))],
            "int8_conv": seen[("int8_conv", ("int8_conv_gemm_kernel",))],
            "int8_prologue": seen[("int8_conv", (
                "int8_conv_quantize_kernel", "int8_conv_im2col_kernel"))]}


def mesh_frames(n=16):
    """``n`` seeded uint8 512x1024 frames on the host (NHWC)."""
    import torch

    return torch.from_numpy(np.random.default_rng(31).integers(
        0, 256, (n, *SERVE_HW, 3), dtype=np.uint8))


def int8_band_cases(device):
    """The int8 kernel with pad_h = 0 on each of two bands of output rows
    of INT8_BAND_CASES (bf16): the band's window (its rows and halo, zeros
    outside the image, as SpatialMesh.exchange gives it) through the
    kernel, bit for bit against the plain version on the same window and
    against the whole kernel's rows; device ms of each band's launch and
    of the whole conv's. Returns {case: (whole ms, [band ms])}."""
    import torch
    import torch.nn.functional as F

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic

    out = {}
    for case in INT8_BAND_CASES:
        _, _, _, _, _, ks, s, p = case
        x, w8, out_mul, bias, inv = int8_inputs(device, case, "bfloat16",
                                                seed=5)
        args = (w8, ic.pack_weights(w8), out_mul, bias, inv, s)
        whole = served("int8 whole", case, lambda: ic.int8_conv(x, *args, p))
        padded = F.pad(x, (0, 0, p, p))
        n_out = whole.shape[2]
        bands = []
        for o0, o1 in ((0, n_out // 2), (n_out // 2, n_out)):
            win = padded[:, :, o0 * s:(o1 - 1) * s + ks].contiguous()
            got = served("int8 band", (case, o0), lambda: ic.int8_conv(
                win, *args, (0, p)))
            plain = ic.int8_conv_reference(win, w8, out_mul, bias, inv, s,
                                           (0, p))
            check(torch.equal(got, plain),
                  f"int8 band {case} rows {o0}:{o1}: the kernel differs "
                  f"from its plain version")
            check(torch.equal(got, whole[:, :, o0:o1]),
                  f"int8 band {case} rows {o0}:{o1}: differs from the "
                  f"whole kernel's rows")
            bands.append(device_ms_or_events(
                lambda: ic.int8_conv(win, *args, (0, p)), ("int8_conv",))[0])
        whole_ms = device_ms_or_events(lambda: ic.int8_conv(x, *args, p),
                                       ("int8_conv",))[0]
        out[case] = (whole_ms, bands)
        log("int8-band", f"{case} bf16: two bands with pad_h = "
            f"0 bit for bit against the plain version and the whole "
            f"kernel's rows; device ms a band {bands[0]:.4f} + "
            f"{bands[1]:.4f} against the whole conv's {whole_ms:.4f}")
    return out


def mesh_rank(rank, world, init, out, device, arts):
    """One of two gloo ranks sharing cuda:0 (mesh-serve phase), a 1 x 2
    spatial mesh: the int8 ``all`` model calibrated whole and evaluated
    in bands over 16 bf16 batches of 8 (profiled, counters reset before
    and read after, peak memory), its band's labels; each batch-sharded
    artifact (bf16, int8) on this rank's 8 of 16 frames, replayed and
    eager, against the one-device artifact on them, timed; the
    height-sharded artifact's program of this rank on its band of batch 1
    and 8 (eager under gloo), timed, its exchanges counted."""
    import torch

    from dasemanticsegmentationaml_tpu_torch import serve
    from dasemanticsegmentationaml_tpu_torch.ops.quantize import (
        quantize_model)
    from dasemanticsegmentationaml_tpu_torch.parallel import spatial as sp
    from dasemanticsegmentationaml_tpu_torch.parallel.distributed import (
        allreduce_counts, barrier, destroy, initialize)
    from dasemanticsegmentationaml_tpu_torch.train import evaluate as ev
    from dasemanticsegmentationaml_tpu_torch.utils import export as ex

    device = torch.device(device)
    torch.cuda.set_device(device)
    initialize(init, world, rank, backend="gloo", device=device)
    bf16 = torch.bfloat16
    try:
        mesh = sp.create_mesh_spatial(1, world)
        res = {}
        batches = eval_batches(device)
        qmodel, _ = quantize_model(
            seeded_g(device).eval(),
            [images for images, _ in batches[:MESH_CALIB_BATCHES]],
            amp_dtype=bf16)
        mesh.convert(qmodel)
        reset_eval_counts(ev)
        before = mesh_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0, t0 = mesh.exchanges, time.perf_counter()
        (hist, correct, total), prof = profiled(lambda: ev.eval_counts(
            qmodel, batches, 19, prepare=lambda b: b, device=device,
            amp_dtype=bf16, spatial=mesh))
        seconds = time.perf_counter() - t0
        after = mesh_counts()
        peak = torch.cuda.max_memory_allocated()
        exchanges = (mesh.exchanges - n0) / len(batches)
        hist, correct, total = allreduce_counts(hist, correct, total)
        preds = torch.stack([ev.predict(
            qmodel, mesh.shard(images)[0], True, bf16, spatial=mesh).to(
            torch.uint8).cpu() for images, _ in batches])
        res["int8_eval"] = dict(
            hist=hist.cpu(), correct=int(correct), total=total,
            counts={k: after[k] - before[k] for k in after},
            seen=mesh_seen(prof), peak=peak, preds=preds,
            exchanges=exchanges, seconds=seconds, batches=len(batches))
        del batches, qmodel, prof
        torch.cuda.empty_cache()

        frames = mesh_frames()
        sub = frames[8 * rank:8 * (rank + 1)].pin_memory()
        sub_dev = sub.to(device)
        for kind in ("bf16", "int8"):
            module = ex.load_exported(arts[f"sharded_{kind}"])
            replayed = serve.Program(module, device)
            eager = serve.Program(module, device, capture=False)
            one = serve.Program(ex.load_exported(arts[f"one_{kind}"]),
                                device, capture=False)
            want = one(sub)
            before = mesh_counts()
            (got_replayed, got_eager), prof = profiled(
                lambda: (replayed(sub), eager(sub)))
            after = mesh_counts()
            counts = {k: after[k] - before[k]
                      + replayed.replayed.get(k, 0)
                      - replayed.captured.get(k, 0) for k in after}
            barrier()
            replayed_ms = cuda_ms(lambda: replayed(sub_dev, to_host=False),
                                  10)
            barrier()
            eager_ms = cuda_ms(lambda: eager(sub_dev, to_host=False), 5)
            res[("sharded", kind)] = dict(
                replayed_equal=bool(torch.equal(got_replayed, want)),
                eager_equal=bool(torch.equal(got_eager, want)),
                counts=counts, seen=mesh_seen(prof),
                replayed_ms=replayed_ms, eager_ms=eager_ms)
            del module, replayed, eager, one, prof

        sp.serve_on(mesh)
        program = serve.Program(ex.read_exported_spatial(
            arts["spatial"], rank).program.module(), device,
            capture=False)
        band = frames.shape[1] // world
        for b in MESH_SPATIAL_BATCHES:
            mine = frames[:b, rank * band:(rank + 1) * band].contiguous()
            before, n0 = mesh_counts(), mesh.exchanges
            labels, prof = profiled(lambda: program(mine))
            after = mesh_counts()
            calls_exchanges = mesh.exchanges - n0
            mine_dev = mine.to(device)
            barrier()
            ms = cuda_ms(lambda: program(mine_dev, to_host=False), 3,
                         warmup=1)
            res[("spatial", b)] = dict(
                labels=labels.to(torch.uint8),
                counts={k: after[k] - before[k] for k in after},
                seen=mesh_seen(prof), exchanges=calls_exchanges, ms=ms)
        torch.save(res, out)
    finally:
        sp.serve_on(None)
        destroy()


def phase_mesh_serve(device, card):
    """int8 eval on the height-sharded mesh and the multi-device serving
    artifacts (docstring, phase 23). Returns {kernel: {path: launches in
    the ranks}}."""
    import torch

    from dasemanticsegmentationaml_tpu_torch import serve
    from dasemanticsegmentationaml_tpu_torch.ops.metrics import per_class_iou
    from dasemanticsegmentationaml_tpu_torch.ops.quantize import (
        quantize_model)
    from dasemanticsegmentationaml_tpu_torch.train import evaluate as ev
    from dasemanticsegmentationaml_tpu_torch.utils import export as ex

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    h, w = SERVE_HW
    launches = {"upsample_argmax": {}, "int8_conv": {}}
    with tempfile.TemporaryDirectory() as tmp:
        model = seeded_g(device).eval()
        batches = eval_batches(device)
        qmodel, _ = quantize_model(
            model, [images for images, _ in batches[:MESH_CALIB_BATCHES]],
            amp_dtype=bf16)
        arts = {}
        for name, fn, m in (
                ("one_bf16", ex.export_inference, model),
                ("sharded_bf16", ex.export_inference_sharded, model),
                ("spatial", ex.export_inference_spatial, model),
                ("one_int8", ex.export_inference, qmodel),
                ("sharded_int8", ex.export_inference_sharded, qmodel)):
            arts[name] = os.path.join(tmp, name + (
                ".zip" if name == "spatial" else ".pt2"))
            t0 = time.perf_counter()
            extra = () if name.startswith("one") else (2,)
            fn(m, h, w, *extra, amp_dtype=bf16, path=arts[name])
            meta = ex.read_meta(arts[name])
            check(meta.get("nr_devices", 1) == (1 if name.startswith("one")
                                                 else 2)
                  and ex.artifact_shard_dim(meta) == int(name == "spatial"),
                  f"{name}: metadata {meta}")
            log("mesh-serve", f"exported {name} in "
                f"{time.perf_counter() - t0:.2f} s, "
                f"{os.path.getsize(arts[name]) / 1e6:.1f} MB, ops "
                f"{meta['ops']}")
        check(ex.read_meta(arts["spatial"])["ops"] == [
            "halo_exchange", "spatial_sum", "upsample_argmax_window"],
            "the spatial artifact does not hold its exchanges, sums and "
            "windowed kernel as nodes")

        # one process's int8 eval, its memory and its labels' yardstick
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hist, correct, total = ev.eval_counts(
            qmodel, batches, 19, prepare=lambda b: b, device=device,
            amp_dtype=bf16)
        peak_one = torch.cuda.max_memory_allocated()

        def labels_of(parts):
            return torch.stack([torch.cat([
                ev.predict(qmodel, piece, True, bf16).to(torch.uint8).cpu()
                for piece in images.chunk(parts)])
                for images, _ in batches])

        preds = labels_of(1)
        yard = float((labels_of(2) == preds).float().mean())
        miou = float(per_class_iou(hist.cpu()).mean())
        # the one-device bf16 artifact's labels of the spatial frames, and
        # its own agreement with batch 8 as two of 4
        frames = mesh_frames()
        one = serve.Program(ex.load_exported(arts["one_bf16"]), device,
                            capture=False)
        spatial_want = {b: one(frames[:b]) for b in MESH_SPATIAL_BATCHES}
        yard_bf16 = float((torch.cat([one(frames[:4]), one(frames[4:8])])
                           == spatial_want[8]).float().mean())
        del batches, qmodel, model, one
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ranks = spawn_parallel(mesh_rank, lambda i, store, out: (
            i, 2, store, out, str(device), arts), 2, timeout=MESH_TIMEOUT)
        t_ranks = time.perf_counter() - t0

        # the banded int8 eval
        got = [r["int8_eval"] for r in ranks]
        got_miou = float(per_class_iou(got[0]["hist"]).mean())
        same = float((torch.cat([g["preds"] for g in got], 2) == preds)
                     .float().mean())
        check(abs(got_miou - miou) <= 1e-3 and got[0]["total"] == total,
              f"banded int8 eval: mIoU {got_miou} against {miou}")
        check(same >= yard - SPATIAL_BF16_SLACK,
              f"banded int8 eval: labels equal on {same}, one process with "
              f"other conv shapes {yard}")
        for r, g in enumerate(got):
            n = g["batches"]
            want = {"upsample_argmax": n, "upsample_argmax_window": n,
                    "int8_conv": QUANT_BLOCKS["all"] * n}
            check(g["counts"] == want and g["seen"]["upsample_argmax"] == n
                  and g["seen"]["int8_conv"] == g["seen"]["int8_prologue"]
                  == want["int8_conv"],
                  f"banded int8 eval rank {r}: launches {g['counts']}, "
                  f"profile {g['seen']}, want {want}")
        launches["upsample_argmax"]["int8_eval"] = sum(
            g["counts"]["upsample_argmax_window"] for g in got)
        launches["int8_conv"]["int8_eval"] = sum(
            g["counts"]["int8_conv"] for g in got)
        log("mesh-serve", f"banded int8 eval (all, 16 bf16 batches of 8, "
            f"two bands): mIoU {got_miou:.6f} against one process's "
            f"{miou:.6f}, precision {got[0]['correct'] / total:.6f} against "
            f"{int(correct) / total:.6f}; labels equal on {same:.6f} (one "
            f"process's own with each batch as two of 4: {yard:.6f}); "
            f"launches a rank {got[0]['counts']} = profile "
            f"{got[0]['seen']}")
        log("mesh-serve", f"{card} | banded int8 eval: "
            f"{got[0]['seconds'] * 1e3 / got[0]['batches']:.2f} ms a batch "
            f"on rank 0 (host clock, gloo exchanges included), "
            f"{got[0]['exchanges']:.0f} halo exchanges a batch; peak "
            f"{got[0]['peak'] / 2**30:.3f} / {got[1]['peak'] / 2**30:.3f} "
            f"GiB a rank against one process's {peak_one / 2**30:.3f} GiB")

        # the batch-sharded artifacts
        for kind in ("bf16", "int8"):
            got = [r[("sharded", kind)] for r in ranks]
            per_call = {"upsample_argmax": 1, "upsample_argmax_window": 0,
                        "int8_conv": QUANT_BLOCKS["all"] * (kind == "int8")}
            for r, g in enumerate(got):
                check(g["replayed_equal"] and g["eager_equal"],
                      f"sharded {kind} rank {r}: the artifact differs from "
                      f"the one-device artifact on the same sub-batch")
                # warm-up, replay and the eager call
                want = {k: 3 * v for k, v in per_call.items()}
                check(g["counts"] == want
                      and g["seen"]["upsample_argmax"]
                      == want["upsample_argmax"]
                      and g["seen"]["int8_conv"] == want["int8_conv"],
                      f"sharded {kind} rank {r}: launches {g['counts']}, "
                      f"profile {g['seen']}, want {want}")
                for k in ("upsample_argmax", "int8_conv"):
                    launches[k]["sharded_serve"] = launches[k].get(
                        "sharded_serve", 0) + g["counts"][k]
            log("mesh-serve", f"{card} | batch-sharded {kind} artifact, two "
                f"gloo ranks on one card, 8 a rank: bit for bit against the "
                f"one-device artifact; replayed {got[0]['replayed_ms']:.3f} "
                f"/ {got[1]['replayed_ms']:.3f} ms a rank's batch "
                f"({sum(8e3 / g['replayed_ms'] for g in got):.1f} images/s "
                f"summed over the ranks, run together), eager "
                f"{got[0]['eager_ms']:.3f} / {got[1]['eager_ms']:.3f} ms "
                f"({sum(8e3 / g['eager_ms'] for g in got):.1f} images/s)")

        # the height-sharded artifact
        for b in MESH_SPATIAL_BATCHES:
            got = [r[("spatial", b)] for r in ranks]
            labels = torch.cat([g["labels"] for g in got], 1)
            same_b = float((labels == spatial_want[b].to(torch.uint8))
                           .float().mean())
            check(same_b >= yard_bf16 - SPATIAL_BF16_SLACK,
                  f"spatial artifact batch {b}: labels equal on {same_b}, "
                  f"one process with other conv shapes {yard_bf16}")
            for r, g in enumerate(got):
                want = {"upsample_argmax": 1, "upsample_argmax_window": 1,
                        "int8_conv": 0}
                check(g["counts"] == want
                      and g["seen"]["upsample_argmax"] == 1
                      and g["exchanges"] > 0,
                      f"spatial artifact batch {b} rank {r}: launches "
                      f"{g['counts']}, profile {g['seen']}, exchanges "
                      f"{g['exchanges']}")
                launches["upsample_argmax"]["spatial_serve"] = launches[
                    "upsample_argmax"].get("spatial_serve", 0) + 1
            log("mesh-serve", f"{card} | height-sharded bf16 artifact, two "
                f"gloo ranks on one card, batch {b}: labels equal to the "
                f"one-device artifact's on {same_b:.6f} (its own batch 8 "
                f"as two of 4: {yard_bf16:.6f}); {got[0]['ms']:.2f} / "
                f"{got[1]['ms']:.2f} ms a batch a rank (eager, gloo "
                f"exchanges included), {got[0]['exchanges']} exchanges a "
                f"batch")

        # the runner over both kinds, as a user runs it
        images = os.path.join(tmp, "images")
        os.makedirs(images)
        from PIL import Image

        for i in range(MESH_SERVE_IMAGES):
            Image.fromarray(frames[i].numpy()).save(
                os.path.join(images, f"m_{i}.png"))
        for name, batch in (("sharded_bf16", 8), ("spatial", 2)):
            outdir = os.path.join(tmp, f"out_{name}")
            t0 = time.perf_counter()
            stats = serve.main([arts[name], "--images", images, "--output",
                                outdir, "--batch_size", str(batch),
                                "--device", "cuda:0,cuda:0"])
            got = torch.stack([torch.from_numpy(np.asarray(Image.open(
                os.path.join(outdir, f"m_{i}_trainIds.png"))))
                for i in range(MESH_SERVE_IMAGES)])
            want = spatial_want[8].to(torch.uint8)
            same_s = float((got == want).float().mean())
            check(stats["images"] == MESH_SERVE_IMAGES
                  and stats["ranks"] == 2
                  and same_s >= yard_bf16 - SPATIAL_BF16_SLACK,
                  f"serve.main {name}: {stats}, labels equal on {same_s}")
            log("mesh-serve", f"serve.main {name} --device cuda:0,cuda:0: "
                f"{stats['images']} images in "
                f"{time.perf_counter() - t0:.1f} s (spawn included), shard "
                f"dim {stats['shard_dim']}, labels equal to the one-device "
                f"artifact's on {same_s:.6f}")
    log("mesh-serve", f"passed: ranks {t_ranks:.1f} s, in all "
        f"{time.perf_counter() - t_phase:.1f} s; launches in the ranks "
        f"{launches}")
    return launches


#: the HPO phase's in-process trial: its tuner values, epochs and steps
HPO_TRIAL = {"batch_size": 8, "num_epochs": 3}
HPO_STEPS_PER_EPOCH = 2
#: seconds a trial of the HPO phase's experiment may take
HPO_TRIAL_TIMEOUT = 600


def hpo_da_step_ms(device, card, batch_sizes):
    """The trial's DA step (bf16, FC D, ``--d_head 2``, the combined
    ordering) on the CLI's 1024 x 512 batches (``--faithful_resize``) at
    each of ``batch_sizes``: {batch: ms/step},
    CUDA events over a chain of 5 steps after 2 of warm-up."""
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
    g_opt = make_optimizer("sgd", trainable_parameters(g), 1e-3,
                           momentum=0.9, weight_decay=5e-4)
    d_opt = make_optimizer("adam", d.parameters(), 1e-4, betas=(0.9, 0.99))
    step = make_da_step(g, d, g_opt, d_opt, lambda_adv=1e-3, d_head=2,
                        step_mode="combined", amp_dtype=torch.bfloat16)
    rng = np.random.default_rng(8)
    times = {}
    for b in sorted(set(batch_sizes)):
        labels = rng.integers(0, 35, (b, 1024, 512)).astype(np.uint8)
        xs, ys = prepare_batch(
            rng.integers(0, 256, (b, 1024, 512, 3), dtype=np.uint8), labels,
            device=device, remap=True, dtype=torch.bfloat16)
        xt, _ = prepare_batch(
            rng.integers(0, 256, (b, 1024, 512, 3), dtype=np.uint8), labels,
            device=device, dtype=torch.bfloat16)
        times[b] = cuda_ms(lambda: step(xs, ys, xt), 5, warmup=2)
        log("hpo", f"the trial's DA step (bf16, FC D, --d_head 2, combined),"
            f" batch {b}, the CLI's 1024x512: {times[b]:.3f} ms/step = "
            f"{1000.0 * b / times[b]:.1f} images/s | {card}")
    return times


def phase_hpo(device, card):
    """The port's HPO harness on the card (docstring, phase 24): one trial
    in-process, then a two-trial experiment in subprocesses. Returns the
    in-process trial's launches."""
    import torch

    from dasemanticsegmentationaml_tpu_torch import cli
    from dasemanticsegmentationaml_tpu_torch.hpo import experiment, trial

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        gta, cs = os.path.join(root, "gta5"), os.path.join(root, "cityscapes")
        write_gtav(gta, n=16)
        write_cityscapes(cs, "train", n=16, seed=1)
        write_cityscapes(cs, "val", n=4)
        trees = ["--root", cs, "--root_source", gta, "--root_target", cs,
                 "--dtype", "bfloat16", "--cuda", "0",
                 "--tensorboard", "False"]

        # one trial in-process: each validation's mIoU as evaluate returned
        # it, against the records the trial wrote
        out = os.path.join(root, "trial.jsonl")
        evaluated = []
        evaluate = cli.evaluate

        def recording(*a, **kw):
            result = evaluate(*a, **kw)
            evaluated.append(result[1])
            return result

        steps = HPO_TRIAL["num_epochs"] * HPO_STEPS_PER_EPOCH
        reset_ce_counts()
        cli.evaluate = recording
        t0 = time.perf_counter()
        try:
            miou = trial.main(trees + [
                "--nni_params", json.dumps(HPO_TRIAL), "--nni_output", out,
                "--validation_step", "1",
                "--max_steps_per_epoch", str(HPO_STEPS_PER_EPOCH),
                "--save_model_path", os.path.join(root, "ck")])
        finally:
            cli.evaluate = evaluate
        secs = time.perf_counter() - t0
        launches = ce_counts()
        with open(out) as f:
            recs = [json.loads(line) for line in f]
        log("hpo", f"trial.main in-process, {HPO_TRIAL}, 1024x512, bf16, "
            f"{steps} DA steps: final {miou}; records {recs}; evaluate "
            f"returned {evaluated}; {secs:.2f} s (set-up, validations and "
            f"checkpoints included); launches {launches} | {card}")
        check(launches["fused_ce_fwd"] == 2 * steps
              and launches["fused_ce_bwd"] == 2 * steps,
              f"fused CE launches {launches}, expected {2 * steps} each")
        check(launches["upsample_argmax"] > 0,
              "the trial's validations did not launch upsample_argmax")
        validations = HPO_TRIAL["num_epochs"] - 1
        check([r["type"] for r in recs]
              == ["intermediate"] * validations + ["final"],
              f"records {recs}")
        check([r["value"] for r in recs[:-1]] == evaluated[:validations]
              and len(evaluated) == validations + 1,
              f"intermediate records {recs} against evaluate's {evaluated}")
        check(recs[-1]["value"] == max(evaluated[:validations]) == miou
              and math.isfinite(miou), f"final record {recs[-1]}, {miou}")

        # two trials through the experiment runner, each a process of its
        # own; its subprocess.run timed and its return codes kept
        torch.cuda.empty_cache()
        procs = []
        run = experiment.subprocess.run

        def timed_run(cmd, **kw):
            t = time.perf_counter()
            proc = run(cmd, **kw)
            procs.append((proc.returncode, time.perf_counter() - t,
                          proc.stderr[-2000:]))
            return proc

        path = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + ([path] if path else []))
        experiment.subprocess.run = timed_run
        t0 = time.perf_counter()
        try:
            res = experiment.run_experiment(
                static_args=trees + [
                    "--max_steps_per_epoch", "1",
                    "--save_model_path", os.path.join(root, "trials")],
                max_trials=2, concurrency=1, seed=0,
                max_hours=2 * HPO_TRIAL_TIMEOUT / 3600,
                results_path=os.path.join(root, "sweep.jsonl"),
                use_nni=False)
        finally:
            experiment.subprocess.run = run
            if path is None:
                del os.environ["PYTHONPATH"]
            else:
                os.environ["PYTHONPATH"] = path
        secs = time.perf_counter() - t0
        for t, (rc, t_secs, err) in zip(res["trials"], procs):
            log("hpo", f"trial {t['id']}: rc {rc}, {t_secs:.1f} s, final "
                f"mIoU {t['miou']}, params {t['params']} | {card}")
            check(rc == 0, f"trial {t['id']} exited with {rc}:\n{err}")
        mious = [t["miou"] for t in res["trials"]]
        log("hpo", f"run_experiment(max_trials=2): {secs:.1f} s; best "
            f"{res['best_miou']} of {mious} | {card}")
        check(len(procs) == len(mious) == 2
              and all(math.isfinite(m) and not t["timed_out"]
                      for m, t in zip(mious, res["trials"]))
              and res["best_miou"] == max(mious),
              f"the experiment's trials {res['trials']}")
        batch_sizes = [HPO_TRIAL["batch_size"]] + [
            t["params"]["batch_size"] for t in res["trials"]]
    hpo_da_step_ms(device, card, batch_sizes)
    log("hpo", f"passed in {time.perf_counter() - t_phase:.1f} s | {card}")
    return launches


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
    from dasemanticsegmentationaml_tpu_torch.data import native
    from dasemanticsegmentationaml_tpu_torch.data import native_augment as na
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import copy_probe as cp
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_stdc as fs
    from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic
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
    builds = ([lib._library for lib in (ua, fc, fs, cp, tr, ic)]
              + [na.library, native.library])
    with futures.ThreadPoolExecutor(len(builds)) as pool:
        for job in [pool.submit(build) for build in builds]:
            job.result()
    sources = ("upsample_argmax", "fused_ce", "fused_stdc", "copy_probe",
               "tile_roll", "int8_conv")
    log("build", f"{', '.join(f'{n}.cu' for n in sources)} (nvcc), "
        f"native/augment.cpp (g++: {na.library_path()}) and "
        f"native/loader.cpp (g++: "
        f"{native.library_path() if native.available() else 'not built'}) "
        f"built (in parallel) and loaded in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    headers, header_err = gxx_finds_image_headers()
    log("build", f"png.h and jpeglib.h on g++'s include path: {headers} "
        f"{header_err}")
    if headers:
        check(native.available(), f"native/loader.cpp did not build: "
              f"{native.unavailable_reason()}")
    else:
        log("build", f"the native decoder is not built here, decode runs on "
            f"PIL: {native.unavailable_reason()}")
    for name in sources:
        for line in BUILD_LOGS.get(name, "").splitlines():
            log("build", f"{name}: {line}")
    if args.baseline:
        compare_baseline(device, card, args.baseline)
        log("done", f"baseline compared in {time.perf_counter() - t_start:.1f}"
            f" s | {card}")
        return 0

    def timed(fn, *fn_args):
        """``fn(*fn_args)``, its wall seconds logged (the budget of the
        script's time limit)."""
        t = time.perf_counter()
        out = fn(*fn_args)
        log("time", f"{fn.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    max_err = timed(phase_kernel, device)
    ce_errs = timed(phase_ce_kernel, device)
    stdc_errs = timed(phase_stdc_kernel, device)
    int8 = timed(phase_int8_kernel, device, card)
    band_ms = timed(int8_band_cases, device)
    (copy_launches, copy_times, copy_others, copy_bound, copy_err,
     copy_turns) = timed(phase_copy_probe, device, card)
    roll_launches, roll_times, roll_bound, roll_err = timed(
        phase_roll_kernel, device, card)
    backbone = seeded_backbone(device)
    stdc_launches, h = timed(phase_stdc_path, device, backbone)
    model = timed(phase_model, device)
    eval_launches = timed(phase_slice)
    int8_launches = timed(phase_int8_slice)
    train_launches = timed(phase_train)
    timed(phase_train_parity, device)
    timed(phase_augment, device, card)
    timed(phase_da)
    timed(phase_da_parity, device)
    timed(phase_resume, device, card)
    timed(phase_da_resume, device, card)
    times = timed(phase_timing, device, model, card)
    window = timed(phase_eval_window, device, card)
    timed(time_train_prefetch, device, card)
    stdc_times = timed(time_stdc, device, backbone, h, card)
    timed(time_da_step, device, card)
    timed(phase_loader, card, headers, times["train"]["kernel"][0] / 8)
    # last: after its profiles of graph replays (the card's tracer has lost
    # kernel records there) a later profile once saw no kernel at all
    serve_launches = timed(phase_serve, device, card, window)
    # after the profiled phases: its parent process profiles nothing (its
    # ranks profile in fresh processes), and with it before the timing
    # phases a CatBottleneck profile there saw no kernel in three tries
    parallel_launches = timed(phase_parallel, device, card)
    spatial_launches = timed(phase_spatial, device, card)
    mesh_launches = timed(phase_mesh_serve, device, card)
    hpo_launches = timed(phase_hpo, device, card)

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
                      plain_device_ms=argmax[("plain", "device")],
                      serve_launches=serve_launches["upsample_argmax"],
                      parallel_launches=parallel_launches["upsample_argmax"],
                      spatial_launches=spatial_launches["upsample_argmax"],
                      mesh_launches=mesh_launches["upsample_argmax"],
                      hpo_launches=hpo_launches["upsample_argmax"])
        ] + [
        kernel_record(f"fused_ce_{part}", CE_SOURCE, CE_REPLACES,
                      train_launches[f"fused_ce_{part}"],
                      ce_errs["loss" if part == "fwd" else "grad"],
                      ce[(part, "kernel")], ce[(part, "plain")],
                      bound_ce(ce_shape, ce_hw, 2, n_valid, part == "bwd"),
                      device_ms=ce[(part, "kernel", "device")],
                      plain_device_ms=ce[(part, "plain", "device")],
                      parallel_launches=parallel_launches[f"fused_ce_{part}"],
                      spatial_launches=spatial_launches[f"fused_ce_{part}"],
                      hpo_launches=hpo_launches[f"fused_ce_{part}"])
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
                      shape=[16384, 8192], dtype="bfloat16"),
        kernel_record("int8_conv", INT8_SOURCE, INT8_REPLACES,
                      int8_launches["int8_conv"], int8["max_err"],
                      int8["ms"], int8["plain_ms"], int8["bound"],
                      int8["library_ms"], device_ms=int8["device_ms"],
                      cudnn_bf16_ms=int8["cudnn_bf16_ms"],
                      cudnn_bf16_device_ms=int8["cudnn_bf16_device_ms"],
                      serve_launches=serve_launches["int8_conv"],
                      mesh_launches=mesh_launches["int8_conv"],
                      band_device_ms={str(list(case)): {
                          "whole": whole, "bands": bands}
                          for case, (whole, bands) in band_ms.items()},
                      shape=int8["shape"], dtype="bfloat16")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
