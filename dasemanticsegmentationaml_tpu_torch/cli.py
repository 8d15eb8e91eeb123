"""CLI entry point: the reference train.py's ``--domain_shift`` mode.

Counterpart of ``dasemanticsegmentationaml_tpu/cli.py`` (main :281; the
eval-only branch :472-476 and :591-599; datasets :312-403). It loads a
checkpoint into BiSeNet-STDC813 and evaluates it on the Cityscapes val set
(or the GTA5 25% split with ``--dataset GTAV``), printing precision and
mIoU like the reference's ``val()`` (train.py:24-61).

``--cuda`` picks the device: ``cpu``, or the index ``n`` of ``cuda:n``;
without CUDA the latter stops with ``SystemExit``, it never drops to the
CPU. Supervised training, domain adaptation, int8, export, the data cache,
multi-device and multi-process runs and host augmentation stop with
``SystemExit("not ported yet: see ROADMAP.md")``.

Run:  python -m dasemanticsegmentationaml_tpu_torch.cli --domain_shift True \
          --root <cityscapes> --pretrain_path best.pth --cuda 0
"""

from __future__ import annotations

import contextlib

import torch

from .data.datasets import CityScapes, GtaV, Subset, train_val_split
from .data.pipeline import Loader, prepare_batch
from .models.bisenet import build_bisenet
from .train.evaluate import evaluate
from .utils.config import parse_args
from .utils.weights import load_pretrain

NOT_PORTED = "not ported yet: see ROADMAP.md"


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
    """Stop on every flag whose path the port does not have yet."""
    unported = {
        "training (the port runs --domain_shift True only)":
            not args.domain_shift,
        "--quantize_int8": args.quantize_int8,
        "--export_model": args.export_model,
        "--data_cache": args.data_cache,
        "--resume": args.resume,
        "--host_augment True": args.host_augment,
        "multi-process runs": (args.coordinator_address is not None
                               or (args.num_processes or 1) > 1),
        "multi-device runs": ((args.num_devices or 1) > 1
                              or args.spatial_devices > 1),
    }
    for what, requested in unported.items():
        if requested:
            raise SystemExit(f"{what}: {NOT_PORTED}")


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


def main(argv=None):
    args = parse_args(argv)
    check_ported(args)
    device = resolve_device(args.cuda)

    # ---- datasets (reference train.py:444-491) ---------------------------
    if args.dataset == "GTAV":
        dataset = GtaV(args.root, args.crop_height, args.crop_width,
                       faithful_resize=args.faithful_resize)
        _train_idx, val_idx = train_val_split(len(dataset))
        val_ds = Subset(dataset, val_idx)
        remap = True
    else:
        val_ds = CityScapes("val", args.root, args.crop_height,
                            args.crop_width,
                            faithful_resize=args.faithful_resize)
        remap = False
    loader = Loader(val_ds, args.eval_batch_size,
                    num_workers=args.num_workers,
                    pin_memory=device.type == "cuda")

    # ---- model ------------------------------------------------------------
    model = build_bisenet(args.num_classes, device=device,
                          generator=torch.Generator().manual_seed(args.seed),
                          backbone_name=args.backbone,
                          use_conv_last=args.use_conv_last)
    load_pretrain(model, args.pretrain_path)
    amp_dtype = torch.bfloat16 if args.dtype == "bfloat16" else None

    def prepare(batch):
        images, labels = batch
        return prepare_batch(images, labels, device=device, remap=remap,
                             dtype=amp_dtype or torch.float32)

    # ---- eval-only mode (reference train.py:511,519) ----------------------
    with fp32_math() if amp_dtype is None else contextlib.nullcontext():
        precision, miou = evaluate(
            model, loader, args.num_classes, prepare=prepare, device=device,
            use_fused_kernel=args.use_fused_eval, amp_dtype=amp_dtype)
    return {"precision": precision, "miou": miou}


if __name__ == "__main__":
    main()
