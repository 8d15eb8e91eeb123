"""CLI entry point: the reference train.py's supervised, adversarial
domain-adaptation and ``--domain_shift`` modes.

Counterpart of ``dasemanticsegmentationaml_tpu/cli.py`` (main :281;
datasets :312-403; the eval-only branch :472-476 and :591-599; the DA
branch :601-711; the supervised branch :713-763; ``maybe_resume``
:128-150). By default it trains
BiSeNet-STDC813 on the Cityscapes train split (or the GTA5 75% split with
``--dataset GTAV``), validating and checkpointing as the reference's
``train()`` does (train.py:63-120), and ends with a full validation. With
``--domain_adaptation True`` it adapts from GTA5 (``--root_source``) to
the Cityscapes train split (``--root_target``) with a discriminator, as
the reference's ``train_DA()`` (train.py:134-299), validating on the
``--root`` val set. With ``--domain_shift True`` it evaluates
``--pretrain_path`` on the val set, printing precision and mIoU like the
reference's ``val()`` (train.py:24-61).

``--aug_type`` augments the GTA5 training batches (``--dataset GTAV``, or
the DA source) with one of the reference's menus: on the device, in
``prepare_batch`` (data/augment.py), or with ``--host_augment True`` on
the host, in the loader's decode threads (data/host_augment.py, the
native C++ ops). ``--augment_labels`` warps the labels with the image.
``--fast_device_geometry`` is accepted and does nothing: its 3-shear
rotation is a TPU workaround the port does not need. ``--profile_dir``
writes a ``torch.profiler`` trace of the first training steps.

``--eval_scan_window K`` evaluates K same-shaped batches per CUDA-graph
replay (``train/evaluate.py``), for ``--domain_shift`` and for the
validations of training. ``--domain_shift True --quantize_int8 True``
calibrates on the first ``--calib_batches`` val batches and evaluates
the int8 model (``ops/quantize.py``: the blocks ``--quantize_filter``
picks run the hand-written int8 kernel, with ``--quantize_clip``'s
activation scales; JAX cli.py:477-489). ``--worker_timeout`` and
``--fetch_timeout`` are the loader's and the prefetch's watchdogs
(``data/pipeline.py``).

Every checkpoint also writes the full train state under
``<save_model_path>/state/`` (``utils/checkpoint.py``), and ``--resume
<save_model_path>/state`` continues a run from it: the model, the
optimizer and the ``--iter_size`` accumulation (DA: G and D, each with its
optimizer), from the epoch after the last checkpoint. As in JAX, the best
mIoU and the TensorBoard step restart from 0. ``--iter_size k``
accumulates k mini-steps per optimizer step (supervised;
``train/optim.py::GradientAccumulator``, optax ``MultiSteps``).
``--data_cache DIR`` decodes each dataset once into memmaps under DIR
(``data/cache.py``). Images decode through the native library
(``data/native.py``); when it cannot be built the CLI prints why and
decodes with PIL, to the same bytes.

``--domain_shift True --export_model PATH`` also writes the serving
artifact of the evaluated model (int8 when quantized), before the
certifying eval: a ``torch.export`` program holding the hand kernels as
custom ops (``utils/export.py``), at the orientation the loader produces,
with a symbolic batch, or a bundle of the ``--export_batches`` sizes;
``serve.py`` replays it (JAX cli.py:490-590).

``--cuda`` picks the device: ``cpu``, or the index ``n`` of ``cuda:n``;
without CUDA the latter stops with ``SystemExit``, it never drops to the
CPU; an artifact is exported on that device and runs on its type.

Data parallelism (JAX cli.py:140-207, :289-310, :660-690, :725-750;
``parallel/``): ``--num_devices N`` starts N ranks of one process group,
one a device: cards ``--cuda`` to ``--cuda`` + N - 1 over NCCL (a machine
with fewer stops, naming the count), or N CPU ranks over gloo under
``--cuda cpu``. ``--num_processes``, ``--process_id`` and
``--coordinator_address`` (or torchrun's environment) make this process
one rank, on the card ``--cuda`` (plus torchrun's ``LOCAL_RANK``). Rank r
loads rows ``[r B/N, (r+1) B/N)`` of every global batch and takes those
rows' augmentation draws, so N ranks see the batches of one process.
``--sync_bn True`` normalises over the global batch and ``False`` keeps
each rank's BN statistics (single-process only, the batch divisible by
N); evaluation reads rank 0's statistics. ``--eval_process_shard`` gives
each rank a strided shard of the val set and sums the int64 counts. Only
rank 0 writes checkpoints, TensorBoard, the JSONL log, the profile and
the export, and prints; the parent of ``--num_devices`` ranks returns
rank 0's result, and a rank that fails ends the others.

The height-sharded mesh (JAX cli.py:164-207, :408-433;
``parallel/spatial.py``): ``--spatial_devices S`` with ``--num_devices N``
spawns the N ranks as a (N / S) data × S spatial mesh. Rank (d, s) loads
data shard d's rows of every global batch, prepares and augments those
whole images (the draws keyed by the global row), and keeps rows ``[s H
/ S, (s + 1) H / S)`` of each; the train and DA steps run banded, with
sync BN over every rank. Validation batches are whole on every rank:
one that the data size divides is counted band by band, another once,
by rank 0, and the int64 counts are summed. Like JAX it stops on
``--num_processes > 1``, on an S that does not divide N, on a height
(``actual_hw``) that ``check_spatial_height`` refuses and on ``--sync_bn
False``, with JAX's words. ``--eval_scan_window`` replays windows only
where the mesh's collectives can be captured (NCCL) and otherwise runs
eagerly, with a note. ``--quantize_int8`` calibrates whole on every rank
(a band cannot reproduce the whole tensor's percentile subsample), then
evaluates the int8 model in bands (JAX cli.py:419-424): each int8 block
fetches its halo and runs the kernel on its window
(``ops/quantize.py::QuantBlock``).

``--export_devices N`` writes an artifact served by N ranks (JAX
cli.py:525-575): batch-sharded (``utils/export.py::
export_inference_sharded``, a symbolic batch a rank; a bundle of
batch-sharded programs under ``--export_batches``), or with
``--export_spatial True`` height-sharded (``export_inference_spatial``:
one program a rank, the exchanges held as nodes); on cards N must not
exceed the card count (JAX's words). ``--export_spatial`` with one device
is the one-device export, as in JAX. ``--iter_size > 1`` with
``--domain_adaptation`` and ``--export_batches`` with ``--export_spatial``
stop with the JAX package's reasons, and so do the data-parallel flags
JAX refuses. ``--use_gpu`` (``INERT_FLAGS``) is
accepted and does nothing; a value other than the default prints a note.

Run:  python -m dasemanticsegmentationaml_tpu_torch.cli --dataset Cityspaces \
          --root <cityscapes> --cuda 0
      python -m dasemanticsegmentationaml_tpu_torch.cli --dataset GTAV \
          --root <gta5> --aug_type CS-HF --cuda 0
      python -m dasemanticsegmentationaml_tpu_torch.cli \
          --domain_adaptation True --root_source <gta5> \
          --root_target <cityscapes> --root <cityscapes> --cuda 0 \
          [--aug_type H-RP [--host_augment True] [--augment_labels True]]
      python -m dasemanticsegmentationaml_tpu_torch.cli --root <cityscapes> \
          --num_devices 4 --cuda 0 [--sync_bn False | --spatial_devices 2]
      python -m dasemanticsegmentationaml_tpu_torch.cli --domain_shift True \
          --root <cityscapes> --pretrain_path best.pth --cuda 0 \
          [--eval_scan_window 8] [--quantize_int8 True \
          --quantize_filter head_ch --calib_batches 4] \
          [--export_model bisenet.pt2 [--export_batches 1,8]]
"""

from __future__ import annotations

import contextlib
import itertools
import os

import torch
import torch.distributed as dist

from .data import native
from .data.augment import batch_generator
from .data.datasets import CityScapes, GtaV, Subset, train_val_split
from .data.host_augment import HostAugment
from .data.pipeline import Loader, prepare_batch
from .models.bisenet import build_bisenet, trainable_parameters
from .models.discriminator import build_discriminator
from .ops.quantize import PRESET_FILTERS, quantize_model
from .parallel.distributed import (assert_same_across_processes, barrier,
                                   destroy, initialize, local_batch_size,
                                   process_rank, spawn)
from .parallel.mesh import (check_per_replica_batch, make_sharded_da_step,
                            make_sharded_train_step, rank0_buffers)
from .parallel.spatial import (check_spatial_height, create_mesh_spatial,
                               keep_band)
from .train.adversarial import make_da_step, train_da
from .train.evaluate import EvalGraphs, evaluate
from .train.optim import GradientAccumulator, make_optimizer
from .train.supervised import make_train_step, train
from .utils import state_io
from .utils.checkpoint import make_checkpoint_fn
from .utils.config import build_parser, parse_args
from .utils.export import (export_inference, export_inference_bundle,
                           export_inference_sharded, export_inference_spatial)
from .utils.logging_util import JsonlLogger, Profiler, make_writer
from .utils.weights import load_pretrain, load_pretrain_discriminator

#: JAX cli.py:603-611
DA_ITER_SIZE = ("--iter_size > 1 is supervised-only: the 4-phase DA step "
                "applies the phase-1 update before phase 2, which gradient "
                "accumulation would defer")
FAST_GEOMETRY_NOTE = ("--fast_device_geometry: accepted and inert on the "
                      "port (its 3-shear rotation avoids the TPU's slow "
                      "gathers; B-GS-R rotates by one gather here)")
#: flags the port parses and does not read, each with the note printed
#: when it is given a value other than its default: ``--use_gpu``, which
#: asks for nothing here
INERT_FLAGS = {
    "use_gpu": "--use_gpu: accepted for CLI compatibility; --cuda picks "
               "the device",
}
#: printed when --eval_scan_window meets a spatial mesh over gloo
SPATIAL_EAGER_NOTE = (
    "--eval_scan_window with --spatial_devices: the mesh's collectives run "
    "over gloo here and cannot be captured in a CUDA graph; evaluating "
    "eagerly (the counts are the same)")
#: JAX cli.py:503-512
EXPORT_BUNDLE_SPATIAL = (
    "--export_batches and --export_spatial cannot be combined: the bundle "
    "route has no spatial-sharded program variant. Export them as two "
    "artifacts.")


def resolve_device(cuda: str) -> torch.device:
    """``--cuda cpu`` -> the CPU; ``--cuda n`` -> ``cuda:n``, which must
    exist."""
    if cuda.strip().lower() == "cpu":
        return torch.device("cpu")
    try:
        index = int(cuda)
    except ValueError:
        raise SystemExit(f"--cuda {cuda!r}: expected 'cpu' or a device "
                         f"index") from None
    if not torch.cuda.is_available():
        raise SystemExit(f"--cuda {cuda}: CUDA is not available (pass "
                         f"--cuda cpu to run on the CPU)")
    if not 0 <= index < torch.cuda.device_count():
        raise SystemExit(f"--cuda {cuda}: only "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", index)


def check_ported(args) -> None:
    """Stop where the JAX CLI stops before any work: on ``--iter_size >
    1`` with ``--domain_adaptation`` (gradient accumulation cannot be
    grafted onto the 4-phase step), and on ``--export_batches`` with
    ``--export_spatial`` (JAX cli.py:503-512). The refusals JAX's
    multi-device exports make only once the model is evaluated come here,
    before any work, in its words: a bundle's batch that ``--export_devices``
    does not divide (JAX utils/export.py:158-160), a height the spatial
    artifact cannot shard (:252, ``check_spatial_height``)."""
    if args.domain_adaptation and args.iter_size > 1:
        raise SystemExit(DA_ITER_SIZE)
    if args.export_batches and args.export_spatial:
        raise SystemExit(EXPORT_BUNDLE_SPATIAL)
    n = args.export_devices
    if not (args.export_model and n > 1):
        return
    if args.export_batches:
        for b in (int(b) for b in args.export_batches.split(",") if b):
            if b % n:
                raise SystemExit(f"batch {b} not divisible by the "
                                 f"{n}-device mesh")
    elif args.export_spatial:
        try:
            check_spatial_height(actual_hw(args)[0], n)
        except ValueError as e:
            raise SystemExit(str(e))


def maybe_resume(args, module, optimizer, accumulator=None,
                 alias: str = "latest") -> int:
    """``--resume <dir>``: restore the state ``alias`` into ``module``,
    ``optimizer`` and ``accumulator``; returns the first epoch to run,
    the one after the EPOCH marker's, or ``--epoch_start_i`` without a
    marker (JAX cli.py:128-150). The best mIoU and the TensorBoard step
    counter are not part of the state: they restart from 0, as in JAX."""
    if not args.resume:
        return args.epoch_start_i
    if not os.path.exists(state_io.state_path(args.resume, alias)):
        have = (sorted(f[:-3] for f in os.listdir(args.resume)
                       if f.endswith(".pt"))
                if os.path.isdir(args.resume) else [])
        raise SystemExit(
            f"--resume: no '{alias}' state under {args.resume} "
            f"(found: {have or 'nothing'}); the run died before its "
            f"first checkpoint epoch")
    state = state_io.restore_train_state(args.resume, alias)
    if (state["accumulator"] is None) != (accumulator is None):
        saved = (1 if state["accumulator"] is None
                 else state["accumulator"]["every_k"])
        raise SystemExit(
            f"--resume: {args.resume}/{alias} was saved with --iter_size "
            f"{saved}; resume it with the same --iter_size")
    module.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    if accumulator is not None:
        accumulator.load_state_dict(state["accumulator"])
    epoch = state_io.latest_epoch_marker(args.resume)
    start = (epoch + 1) if epoch is not None else args.epoch_start_i
    print(f"resumed from {args.resume}/{alias} at epoch {start}")
    return start


def native_decoder_note():
    """One line when images decode with PIL because the native library
    did not build or load here, naming why; None when it is in use."""
    reason = native.unavailable_reason()
    if reason is None:
        return None
    lines = [line.strip() for line in reason.splitlines() if line.strip()]
    errors = [line for line in lines if "error" in line.lower()]
    why = " | ".join(errors or lines[-1:])
    return (f"native decoder unavailable, decoding with PIL (same bytes, "
            f"slower): {why}")


def resolve_host_augment(aug_type, host_augment, backend,
                         fast_geometry=False, host_cores=None):
    """Where does --aug_type run? Returns (host: bool, note: str|None).

    Copied as it stands from the JAX CLI (cli.py:210-278), so that both
    route alike on every row. Its TPU rows and the figures in them are the
    JAX package's, measured on a TPU; the port passes its device type,
    "cuda" or "cpu", for which the answer is ``bool(host_augment)``: unset
    ("auto") augments on the device. The JAX docstring follows.

    The reference augments on the host in DataLoader workers (reference
    dataset/GTAV.py:32-59, train.py:465-470); our default is device
    kernels. The two GEOMETRIC menus are gather-latency-bound on the
    TPU's serial gather engine — measured 11.9 ms/img (H-RP) / 8.5
    (B-GS-R) vs a 1.53 ms/img DA train step (tools/probe_warp.py,
    tools/bench_aug.py) — so 'auto' (--host_augment unset) routes them
    to the host path (data/host_augment.py, bit-exact Pillow/native-C++
    math) on TPU backends, EXCEPT when:
      * --fast_device_geometry already covers it (B-GS-R's 3-shear,
        1.07 ms/img — the explicitly-requested device path wins), or
      * the host is too small to beat the device warp (native costs
        ~29-39 ms/img/core p=0.5, tools/bench_host_aug.py, so <4 cores
        would CAP the loader below the device path it replaced).
    An EXPLICIT device request still gets the measured-cost warning
    instead of a silent 6-8x slowdown."""
    if aug_type is None:
        return False, None
    geometric = aug_type in ("H-RP", "B-GS-R")
    if not (geometric and backend == "tpu"):
        return bool(host_augment), None
    if fast_geometry and aug_type == "B-GS-R":
        # the 3-shear device rotation was explicitly requested and is
        # cheap (1.07 ms/img) — auto never overrides it to host
        if host_augment:
            return True, ("--host_augment True overrides "
                          "--fast_device_geometry for B-GS-R (the menu "
                          "runs on the host; the device flag is inert)")
        return False, None
    if host_augment is None:  # auto
        # callers pass the EFFECTIVE worker parallelism (min of cores
        # and --num_workers — HostAugment runs inside the Loader's
        # decode workers, so --num_workers is the real ceiling)
        cores = host_cores if host_cores is not None \
            else (os.cpu_count() or 1)
        if cores >= 4:
            return True, (
                f"--aug_type {aug_type}: geometric menus are gather-"
                f"latency-bound on TPU (8.5-11.9 ms/img measured, "
                f"tools/probe_warp.py) — augmenting on the HOST "
                f"({cores} effective aug workers; --host_augment False "
                f"forces the device kernels)")
        # few-worker host: the host path would cap the loader BELOW the
        # device warp (~29-39 ms/img/core vs 8.5-11.9 ms on device)
        extra = (" or --fast_device_geometry True (3-shear, 1.07 "
                 "ms/img, ±1 px envelope)" if aug_type == "B-GS-R"
                 else "")
        return False, (
            f"--aug_type {aug_type}: staying on DEVICE — only {cores} "
            f"effective aug worker(s) (min of host cores and "
            f"--num_workers), too few to beat the device warp "
            f"(~29-39 ms/img/core on host vs 8.5-11.9 ms on device); "
            f"with more cores/workers use --host_augment True{extra}")
    if not host_augment:
        if aug_type == "B-GS-R":
            return False, (
                "WARNING: --aug_type B-GS-R on device: the rotation "
                "gather costs ~8.5 ms/img on TPU (vs a 1.53 ms/img DA "
                "step) — consider --host_augment True, or "
                "--fast_device_geometry True (3-shear, 1.07 ms/img, "
                "±1 px envelope)")
        return False, (
            "WARNING: --aug_type H-RP on device: the perspective warp "
            "gather costs ~11.9 ms/img on TPU (vs a 1.53 ms/img DA "
            "step, tools/probe_warp.py) — consider --host_augment True")
    return True, None


@contextlib.contextmanager
def fp32_math():
    """Full fp32 convolutions and matmuls (cuDNN runs fp32 convolutions in
    TF32 by default), restored on exit: ``--dtype float32`` is the parity
    path, as the JAX package's 'highest' precision is (stdcnet.py:42)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def actual_hw(args):
    """The (H, W) of the tensors the loader produces (JAX cli.py:153):
    under ``--faithful_resize`` the reference's transposed ``PIL.resize``
    makes them ``--crop_width`` tall."""
    if args.faithful_resize:
        return args.crop_width, args.crop_height
    return args.crop_height, args.crop_width


def export_model(args, model, amp_dtype, device) -> None:
    """``--export_model``: the serving artifact of ``model`` (after
    ``--quantize_int8``, so an int8 model carries the int8 kernel) at the
    orientation the loader produces, so that it serves what the
    certifying eval measures; the upsample+argmax kernel by
    ``--use_fused_eval``; a bundle of concrete batches under
    ``--export_batches``; over ``--export_devices`` ranks, batch-sharded
    or (``--export_spatial``) height-sharded (JAX cli.py:490-590)."""
    h, w = actual_hw(args)
    n = args.export_devices
    kwargs = dict(use_fused_kernel=args.use_fused_eval, amp_dtype=amp_dtype,
                  device=device, path=args.export_model)
    if n > 1 and device.type == "cuda" and torch.cuda.device_count() < n:
        # JAX cli.py:527-533 / :546-549 (CPU ranks are processes: any n)
        raise SystemExit(f"--export_devices {n} but only "
                         f"{torch.cuda.device_count()} devices visible")
    if args.export_batches:
        batches = [int(b) for b in args.export_batches.split(",") if b]
        export_inference_bundle(model, h, w, batches, devices=n, **kwargs)
        kind = f"bundle of batches {sorted(set(batches))}"
    elif n > 1 and args.export_spatial:
        export_inference_spatial(model, h, w, n, **kwargs)
        kind = "height-sharded, symbolic batch"
    elif n > 1:
        export_inference_sharded(model, h, w, n, **kwargs)
        kind = "batch-sharded, symbolic batch a rank"
    else:
        export_inference(model, h, w, **kwargs)
        kind = "symbolic batch"
    if n > 1:
        kind += f", {n} ranks"
    print(f"exported serving artifact: {args.export_model} "
          f"({os.path.getsize(args.export_model)} bytes, {device.type}, "
          f"{kind})")


def inert_flag_notes(args):
    """The notes of ``INERT_FLAGS`` given a value other than the default."""
    parser = build_parser()
    return [note for dest, note in INERT_FLAGS.items()
            if getattr(args, dest) != parser.get_default(dest)]


def multi_process(args) -> bool:
    """Is this process one rank of several (the flags, or torchrun's
    environment)?"""
    return ((args.num_processes or 1) > 1
            or args.coordinator_address is not None
            or int(os.environ.get("WORLD_SIZE", "1")) > 1)


def check_spatial(args) -> None:
    """JAX ``build_mesh``'s refusals of ``--spatial_devices > 1``
    (cli.py:164-207), in its order and words."""
    spatial = args.spatial_devices
    if multi_process(args):
        raise SystemExit("--spatial_devices is single-process only")
    total = args.num_devices or 1
    if total % spatial:
        raise SystemExit(f"--spatial_devices {spatial} "
                         f"must divide the device count {total}")
    try:
        check_spatial_height(actual_hw(args)[0], spatial)
    except ValueError as e:
        raise SystemExit(str(e))
    if not args.sync_bn:
        raise SystemExit("--sync_bn False (per-replica BN) is not "
                         "supported with --spatial_devices")


def check_parallel(args) -> int:
    """The rank count of the run, after JAX's refusals (``build_mesh``,
    JAX cli.py:164-207, and :147-159, :532, :595): per-replica BN is
    single-process only and needs the batch divisible by the ranks;
    ``--num_devices`` cannot take a subset of a multi-process run; each
    rank loads batch / ranks samples (batch / data size on a spatial
    mesh, ``check_spatial``)."""
    if args.spatial_devices > 1:
        check_spatial(args)
        world = args.num_devices
        if not args.domain_shift:
            local_batch_size(args.batch_size, world // args.spatial_devices)
        return world
    if multi_process(args):
        world = args.num_processes or int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            raise SystemExit(
                "--coordinator_address needs --num_processes > 1 (or "
                "torchrun's WORLD_SIZE)")
        if args.num_devices not in (None, world):
            raise SystemExit("--num_devices cannot subset a multi-process "
                             "mesh (every process's devices participate)")
        if not args.sync_bn:
            raise SystemExit("--sync_bn False (per-replica BN shard_map) "
                             "is single-process only; multi-process runs "
                             "use global-batch sync BN")
    else:
        world = args.num_devices or 1
        if world < 1:
            raise SystemExit(f"--num_devices {world}: expected >= 1")
    if world > 1 and not args.domain_shift:
        if not args.sync_bn:
            check_per_replica_batch(args.batch_size, world)
        local_batch_size(args.batch_size, world)
    return world


def resolve_devices(cuda: str, n: int):
    """The devices of ``--num_devices n``: n CPU ranks under ``--cuda
    cpu``, else the cards ``--cuda`` to ``--cuda`` + n - 1, which must all
    exist: never fewer ranks, never the CPU."""
    first = resolve_device(cuda)
    if first.type == "cpu":
        return [first] * n
    have = torch.cuda.device_count()
    if first.index + n > have:
        raise SystemExit(
            f"--num_devices {n} --cuda {cuda}: needs {n} CUDA devices "
            f"(cuda:{first.index} to cuda:{first.index + n - 1}); this "
            f"machine has {have}")
    return [torch.device("cuda", first.index + r) for r in range(n)]


def _rank_main(rank: int, world: int, device: torch.device, args,
               report_fn=None):
    """One rank of ``--num_devices``: a process that
    ``parallel/distributed.py::spawn`` started (a file store in a fresh
    temporary directory; a rank that exits with an error ends the others
    and stops the run); rank 0's result goes to the parent, and so do its
    reports (``report_fn``: spawn's sender on rank 0, None on the
    others)."""
    return run(args, device, report_fn)


def main(argv=None, report_fn=None):
    """report_fn(epoch, miou): called after every validation of training,
    the HPO trial's hook (JAX cli.py:281-283), in this process: under
    ``--num_devices`` rank 0's reports reach it through ``spawn``, once
    each, as they are made; under ``--num_processes`` each process calls
    its own, as each JAX process does."""
    args = parse_args(argv)
    check_ported(args)
    world = check_parallel(args)
    if multi_process(args):
        device = resolve_device(args.cuda)
        if device.type == "cuda" and os.environ.get("LOCAL_RANK"):
            device = resolve_device(
                str(device.index + int(os.environ["LOCAL_RANK"])))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        initialize(args.coordinator_address, world, args.process_id,
                   device=device)
        try:
            return run(args, device, report_fn)
        finally:
            destroy()
    if world > 1:
        return spawn(_rank_main, resolve_devices(args.cuda, world), args,
                     report_fn=report_fn)
    return run(args, resolve_device(args.cuda), report_fn)


def run(args, device: torch.device, report_fn=None):
    """The run on ``device``: one process, or one rank of the process
    group this process has joined."""
    rank, world = process_rank()
    if rank > 0:
        # only rank 0 prints (JAX cli.py:467); errors still reach stderr
        with open(os.devnull, "w") as quiet, \
                contextlib.redirect_stdout(quiet):
            return _run(args, device, rank, world, report_fn)
    return _run(args, device, rank, world, report_fn)


def _run(args, device, rank: int, world: int, report_fn=None):
    pin = device.type == "cuda"
    spatial = None
    if args.spatial_devices > 1:
        spatial = create_mesh_spatial(world // args.spatial_devices,
                                      args.spatial_devices)
        data_rank, data_size = spatial.data_index, spatial.data_size
        print(f"spatial mesh: {data_size} data x {args.spatial_devices} "
              f"spatial ranks ({dist.get_backend()}), sync BN; "
              f"{args.batch_size // data_size} of each batch's "
              f"{args.batch_size} rows a data shard, "
              f"{actual_hw(args)[0] // args.spatial_devices} of "
              f"{actual_hw(args)[0]} image rows a rank")
        if args.eval_scan_window > 1 and not spatial.capturable:
            print(SPATIAL_EAGER_NOTE)
    else:
        data_rank, data_size = rank, world
    if world > 1 and spatial is None:
        print(f"data parallel: {world} ranks ({dist.get_backend()}), "
              f"--sync_bn {args.sync_bn}, {args.batch_size // world} of "
              f"each batch's {args.batch_size} rows a rank")
    # per-replica BN keeps each rank's statistics: evaluation reads rank
    # 0's, as JAX evaluates shard 0's state (cli.py:540, :600)
    per_replica = world > 1 and not args.sync_bn
    if args.fast_device_geometry:
        print(FAST_GEOMETRY_NOTE)
    for note in inert_flag_notes(args):
        print(note)
    # HostAugment runs in the loader's decode threads, so --num_workers
    # caps its parallelism (JAX cli.py:340-344)
    host_aug, host_aug_note = resolve_host_augment(
        args.aug_type, args.host_augment, device.type,
        fast_geometry=args.fast_device_geometry,
        host_cores=min(os.cpu_count() or 1, max(1, args.num_workers)))
    if host_aug_note:
        print(host_aug_note)
    decoder_note = native_decoder_note()
    if decoder_note:
        print(decoder_note)

    def maybe_cache(ds):
        """--data_cache: a scan dataset decoded once into memmaps, beneath
        the GTA5 split and HostAugment (JAX cli.py:315-326, 356-372)."""
        if ds is None or not args.data_cache:
            return ds
        from .data.cache import open_or_build
        # ranks > 0 wait for rank 0's publish (JAX cli.py:316-327)
        return open_or_build(ds, args.data_cache,
                             num_workers=args.num_workers,
                             process_id=rank,
                             wait_for_publish=3600.0 if world > 1 else 0.0)

    def maybe_host_augment(ds):
        """--host_augment: the menu runs on the host, in the train
        loader's decode threads (JAX cli.py:345-353)."""
        if not host_aug:
            return ds
        return HostAugment(ds, args.aug_type, seed=args.seed,
                           augment_labels=args.augment_labels)

    # ---- datasets (reference train.py:444-491) ---------------------------
    if args.dataset == "GTAV":
        dataset = maybe_cache(GtaV(
            args.root, args.aug_type, args.crop_height, args.crop_width,
            faithful_resize=args.faithful_resize))
        train_idx, val_idx = train_val_split(len(dataset))
        # wrap the Subset, so that HostAugment's idx is the split's, as
        # in JAX (cli.py:360)
        train_ds = maybe_host_augment(Subset(dataset, train_idx))
        val_ds = Subset(dataset, val_idx)
        remap = True
        aug_train = None if host_aug else args.aug_type
    else:
        # neither eval-only mode nor DA uses a train split from --root
        train_ds = None if args.domain_shift or args.domain_adaptation \
            else maybe_cache(CityScapes(
                "train", args.root, args.crop_height, args.crop_width,
                faithful_resize=args.faithful_resize))
        val_ds = maybe_cache(CityScapes(
            "val", args.root, args.crop_height, args.crop_width,
            faithful_resize=args.faithful_resize))
        remap = False
        aug_train = None
    loader_val = Loader(val_ds, args.eval_batch_size,
                        num_workers=args.num_workers, pin_memory=pin,
                        worker_timeout=args.worker_timeout)
    # int8 calibration reads loader_val, whole on every rank; evaluation
    # reads a strided shard a rank whose counts are summed (JAX
    # cli.py:228-247, 391-397)
    eval_sharded = world > 1 and args.eval_process_shard and spatial is None
    loader_val_eval = Loader(
        Subset(val_ds, list(range(rank, len(val_ds), world))),
        args.eval_batch_size, num_workers=args.num_workers, pin_memory=pin,
        worker_timeout=args.worker_timeout) if eval_sharded else loader_val

    # ---- model ------------------------------------------------------------
    model = build_bisenet(args.num_classes, device=device,
                          generator=torch.Generator().manual_seed(args.seed),
                          backbone_name=args.backbone,
                          use_conv_last=args.use_conv_last)
    load_pretrain(model, args.pretrain_path)
    amp_dtype = torch.bfloat16 if args.dtype == "bfloat16" else None

    def make_prepare(aug_type, remap, sharded=True):
        """prepare(batch, epoch, it): the batch on the device, augmented
        by ``aug_type`` with the draws of (seed, epoch, it), as JAX folds
        epoch and step into its key (cli.py:415-432); on a spatial mesh,
        ``sharded``: this rank's band of it."""
        def prepare(batch, epoch=0, it=0):
            images, labels = batch
            generator = (batch_generator(args.seed, epoch, it, device)
                         if aug_type else None)
            # a rank's rows of the global batch take those rows' draws
            rows = ((data_rank * images.shape[0], args.batch_size)
                    if aug_type and data_size > 1 else None)
            images, labels = prepare_batch(
                images, labels, device=device, remap=remap,
                dtype=amp_dtype or torch.float32, aug_type=aug_type,
                generator=generator, augment_labels=args.augment_labels,
                rows=rows)
            if spatial is not None and sharded:
                # this rank's band of the prepared whole images
                images, labels = (
                    keep_band(t, spatial.spatial_index,
                              spatial.spatial_size).contiguous()
                    for t in (images, labels))
            return images, labels
        return prepare

    # validation batches stay whole: eval counts each rank's band of them
    prepare_val = make_prepare(None, remap, sharded=False)
    if spatial is not None and not args.domain_shift:
        # training converts before its optimizers take the parameters;
        # eval-only converts once quantized and exported (below)
        spatial.convert(model)

    # --eval_scan_window: the windows captured by the first evaluation are
    # replayed by the later ones (each validation of training)
    graphs = EvalGraphs()

    def evaluate_fn(m):
        with (rank0_buffers(m) if per_replica
              else contextlib.nullcontext()):
            result = evaluate(m, loader_val_eval, args.num_classes,
                              prepare=prepare_val, device=device,
                              use_fused_kernel=args.use_fused_eval,
                              amp_dtype=amp_dtype,
                              scan_window=args.eval_scan_window,
                              fetch_timeout=args.fetch_timeout,
                              graphs=graphs, cross_process_sum=eval_sharded,
                              spatial=spatial)
        # the best-checkpoint decision must not part (JAX cli.py:457-461)
        assert_same_across_processes(result[1], "val mIoU")
        return result

    with fp32_math() if amp_dtype is None else contextlib.nullcontext():
        if args.domain_shift:
            # eval-only mode (reference train.py:511,519)
            eval_model = model
            if args.quantize_int8:
                # int8 PTQ (JAX cli.py:477-489): calibrate the activation
                # scales on the first --calib_batches val batches in eval
                # mode, fold BN, run the s8 x s8 -> s32 blocks
                calib = [prepare_val(b)[0] for b in itertools.islice(
                    iter(loader_val), args.calib_batches)]
                eval_model, _ = quantize_model(
                    model, calib,
                    filter_fn=PRESET_FILTERS[args.quantize_filter],
                    clip=args.quantize_clip, amp_dtype=amp_dtype)
            if args.export_model:
                if rank == 0:
                    export_model(args, eval_model, amp_dtype, device)
                barrier()
            if spatial is not None:
                # calibrated whole (above); its int8 blocks take the mesh
                # and evaluate in bands (JAX cli.py:419-424)
                spatial.convert(eval_model)
            precision, miou = evaluate_fn(eval_model)
            return {"precision": precision, "miou": miou}
        profiler = (Profiler(args.profile_dir)
                    if args.profile_dir and rank == 0 else None)
        try:
            if args.domain_adaptation:
                source_ds = maybe_host_augment(maybe_cache(GtaV(
                    args.root_source, args.aug_type, args.crop_height,
                    args.crop_width, faithful_resize=args.faithful_resize)))
                target_ds = maybe_cache(CityScapes(
                    "train", args.root_target, args.crop_height,
                    args.crop_width, faithful_resize=args.faithful_resize))
                max_miou = _train_da(
                    args, model, source_ds, target_ds,
                    make_prepare(None if host_aug else args.aug_type, True),
                    make_prepare(None, False), evaluate_fn, amp_dtype,
                    device, profiler, rank, world, spatial, report_fn)
            else:
                max_miou = _train_supervised(
                    args, model, train_ds, make_prepare(aug_train, remap),
                    evaluate_fn, amp_dtype, pin, profiler, rank, world,
                    spatial, report_fn)
        finally:
            if profiler is not None:
                profiler.close()
        model.eval()
        precision, miou = evaluate_fn(model)
    return {"precision": precision, "miou": miou, "max_miou": max_miou}


def _writer_and_logger(args, rank: int):
    """TensorBoard and the JSONL log, on rank 0 only (JAX cli.py:315-319:
    the ranks would append duplicates to one file)."""
    return ((make_writer(args.tensorboard) if rank == 0 else None),
            JsonlLogger(args.jsonl_log if rank == 0 else None))


def _data_shard(rank: int, world: int, spatial):
    """(the rank's data shard, the shard count): the rank's own on a data
    mesh, its data index on a spatial one."""
    if spatial is not None:
        return spatial.data_index, spatial.data_size
    return rank, world


def _train_supervised(args, model, train_ds, prepare, evaluate_fn,
                      amp_dtype, pin, profiler, rank: int = 0,
                      world: int = 1, spatial=None,
                      report_fn=None) -> float:
    """The supervised branch (JAX cli.py:713-763; reference
    train.py:465-470,501-509). SGD takes weight decay 1e-4, hard-coded as
    the reference does (train.py:504), not ``--weight_decay`` (the DA
    value); Adam and RMSprop take none. Over ranks: each loads its slice
    of the global batch and runs the sharded step (JAX cli.py:725-750);
    on a spatial mesh its data shard's, banded."""
    shard, shards = _data_shard(rank, world, spatial)
    loader_train = Loader(train_ds, args.batch_size, shuffle=True,
                          seed=args.seed, drop_last=True,
                          num_workers=args.num_workers, pin_memory=pin,
                          worker_timeout=args.worker_timeout,
                          process_id=shard, process_count=shards)
    wd = {"sgd": 1e-4}.get(args.optimizer, 0.0)
    optimizer = make_optimizer(
        args.optimizer, trainable_parameters(model, args.use_conv_last),
        args.learning_rate, momentum=0.9, weight_decay=wd)
    # --iter_size: optax.MultiSteps in JAX (cli.py:719-722)
    accumulator = (GradientAccumulator(optimizer, args.iter_size)
                   if args.iter_size > 1 else None)
    args.epoch_start_i = maybe_resume(args, model, optimizer, accumulator)
    if world > 1:
        step = make_sharded_train_step(
            model, optimizer, num_classes=args.num_classes,
            sync_bn=args.sync_bn, ohem=args.ohem, accumulator=accumulator,
            amp_dtype=amp_dtype, spatial=spatial)
    else:
        step = make_train_step(model, optimizer, accumulator=accumulator,
                               ohem=args.ohem, amp_dtype=amp_dtype)
    writer, logger = _writer_and_logger(args, rank)
    try:
        return train(args, model, optimizer, loader_train, prepare=prepare,
                     evaluate_fn=evaluate_fn, train_step=step,
                     writer=writer, logger=logger,
                     checkpoint_fn=make_checkpoint_fn(args.save_model_path),
                     profiler=profiler, accumulator=accumulator,
                     report_fn=report_fn)
    finally:
        logger.close()
        if writer is not None:
            writer.close()


def _train_da(args, model, source_ds, target_ds, prepare_source,
              prepare_target, evaluate_fn, amp_dtype, device,
              profiler, rank: int = 0, world: int = 1,
              spatial=None, report_fn=None) -> float:
    """The DA branch (JAX cli.py:601-711; reference train.py:134-299):
    GTA5 source batches (raw ids remapped, augmented by ``--aug_type``)
    shuffled with ``seed``, Cityscapes target batches shuffled with
    ``seed + 1``; the discriminator seeded with ``seed + 2``; SGD for G
    with ``--momentum`` and ``--weight_decay`` (train.py:170-171),
    Adam(0.9, 0.99) for D (train.py:172). Over ranks: each loads its
    slices and runs the sharded DA step (JAX cli.py:660-690)."""
    pin = device.type == "cuda"
    shard, shards = _data_shard(rank, world, spatial)
    loader_source = Loader(source_ds, args.batch_size, shuffle=True,
                           seed=args.seed, drop_last=True,
                           num_workers=args.num_workers, pin_memory=pin,
                           worker_timeout=args.worker_timeout,
                           process_id=shard, process_count=shards)
    loader_target = Loader(target_ds, args.batch_size, shuffle=True,
                           seed=args.seed + 1, drop_last=True,
                           num_workers=args.num_workers, pin_memory=pin,
                           worker_timeout=args.worker_timeout,
                           process_id=shard, process_count=shards)
    d_model = build_discriminator(
        args.num_classes, args.depthwise, args.batch_norm, device=device,
        generator=torch.Generator().manual_seed(args.seed + 2))
    if args.depthwise:
        print("You are using depthwise separable convolution for the "
              "discrminator "
              + ("with" if args.batch_norm else "without")
              + " batch normalization...")
    if args.d_pretrain_path:
        load_pretrain_discriminator(d_model, args.d_pretrain_path)
    g_opt = make_optimizer("sgd", trainable_parameters(model,
                                                       args.use_conv_last),
                           args.learning_rate, momentum=args.momentum,
                           weight_decay=args.weight_decay)
    d_opt = make_optimizer("adam", d_model.parameters(), args.learning_rate_D,
                           betas=(0.9, 0.99))
    # G from 'latest', D with its Adam state from 'latest_D1' (JAX
    # cli.py:661-663); the schedules fast-forward to the start epoch
    args.epoch_start_i = maybe_resume(args, model, g_opt)
    if args.resume:
        maybe_resume(args, d_model, d_opt, alias="latest_D1")
    kwargs = dict(lambda_adv=args.lambda_adv_target1, d_head=args.d_head,
                  step_mode=args.da_step_mode, amp_dtype=amp_dtype)
    if world > 1:
        step = make_sharded_da_step(model, d_model, g_opt, d_opt,
                                    num_classes=args.num_classes,
                                    sync_bn=args.sync_bn, spatial=spatial,
                                    **kwargs)
    else:
        step = make_da_step(model, d_model, g_opt, d_opt, **kwargs)
    writer, logger = _writer_and_logger(args, rank)
    try:
        return train_da(
            args, model, d_model, g_opt, d_opt, loader_source, loader_target,
            prepare_source=prepare_source, prepare_target=prepare_target,
            evaluate_fn=evaluate_fn, da_step=step, writer=writer,
            logger=logger,
            checkpoint_fn=make_checkpoint_fn(args.save_model_path),
            lr_mode="nni_faithful" if args.nni_faithful_lr else "reference",
            profiler=profiler, report_fn=report_fn)
    finally:
        logger.close()
        if writer is not None:
            writer.close()


if __name__ == "__main__":
    main()
