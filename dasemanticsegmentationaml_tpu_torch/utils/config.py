"""CLI flag surface: the JAX package's flags, names and defaults unchanged.

``dasemanticsegmentationaml_tpu/utils/config.py`` cannot be reused as it
is: its ``build_parser`` imports ``ops/quantize.py`` for the
``--quantize_filter`` choices (config.py:179), and that module imports
JAX. So the surface is restated here, and a test holds every flag's name,
default, type and choices against the JAX parser. Boolean flags take
``str2bool`` as there (the reference's ``type=bool`` made
``--domain_shift False`` truthy, train.py:408-437).

The port runs supervised training, adversarial domain adaptation and
``--domain_shift`` evaluation (with ``--eval_scan_window``, int8 PTQ and
``--export_model``), on one device or data-parallel over ranks
(``--num_devices``, ``--num_processes``);
the CLI stops with ``SystemExit`` on the flags of paths still to be
ported, and the flags only those paths read are inert
(``cli.py::INERT_FLAGS``).
``parse_args`` sets ``args.ohem`` as the JAX one does (config.py:255-262).
"""

from __future__ import annotations

import argparse


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Unsupported value encountered.")


def str2bool_auto(v):
    """Tri-state: True/False like str2bool, or 'auto' -> None."""
    if v is None or (isinstance(v, str) and v.lower() == "auto"):
        return None
    return str2bool(v)


#: the JAX package's ops/quantize.py::PRESET_FILTERS names (the port's
#: ops/quantize.py restates them; a test holds the two lists equal)
QUANTIZE_FILTERS = ("all", "backbone", "deep", "head", "head_ch", "head_ffm",
                    "head_stem", "heads_cp")


# (flag, type, default, choices, help)
_FLAGS = (
    ("--root", str, "../Datasets/Cityscapes", None, "dataset root"),
    ("--root_source", str, "../Datasets/GTA5", None,
     "DA: the GTA5 source tree (images/, labels/)"),
    ("--root_target", str, "../Datasets/Cityscapes", None,
     "DA: the Cityscapes target tree (its train split)"),
    ("--dataset", str, "Cityspaces", None,
     "GTAV or Cityspaces (GTAV evaluates on its 25%% val split)"),
    ("--backbone", str, "STDCNet813", None, "STDC1 family only"),
    ("--pretrain_path", str, "", None,
     "full net iff '.pth' in the path, else backbone iff 'STDCNet'"),
    ("--use_conv_last", str2bool, False, None, "apply conv_last to feat32"),
    ("--num_epochs", int, 50, None, "training epochs"),
    ("--epoch_start_i", int, 0, None, "first epoch"),
    ("--checkpoint_step", int, 10, None, "latest.pth every n epochs"),
    ("--validation_step", int, 1, None,
     "validate (and best.pth) every n epochs"),
    ("--crop_height", int, 512, None, "resize height argument"),
    ("--crop_width", int, 1024, None, "resize width argument"),
    ("--batch_size", int, 8, None, "training batch size"),
    ("--eval_batch_size", int, 1, None, "validation batch size"),
    ("--learning_rate", float, 0.01, None, "base LR (poly decay)"),
    ("--learning_rate_D", float, 1e-3, None,
     "DA: the discriminator's Adam LR (compounding poly decay)"),
    ("--num_workers", int, 4, None, "decode threads"),
    ("--worker_timeout", float, 120.0, None,
     "seconds a sample's decode may take before the loader raises "
     "PipelineStallError naming it; <= 0 waits for ever"),
    ("--fetch_timeout", float, 900.0, None,
     "seconds a batch's fetch (decode wait + prepare_batch) may take "
     "before PipelineStallError; <= 0 fetches in the caller's thread"),
    ("--num_classes", int, 19, None, "classes"),
    ("--cuda", str, "0", None,
     "device: 'cpu', or the index n of cuda:n (no silent CPU fallback)"),
    ("--use_gpu", str2bool, True, None,
     "accepted for CLI compat; --cuda picks the device"),
    ("--save_model_path", str, None, None,
     "latest.pth / best.pth directory (default ./checkpoints)"),
    ("--optimizer", str, "sgd", None, "sgd | adam | rmsprop"),
    ("--loss", str, "crossentropy", None, "crossentropy | ohem"),
    ("--iter_size", int, 1, None,
     "accumulate gradients over n mini-steps (supervised; stops with "
     "--domain_adaptation)"),
    ("--domain_shift", str2bool, False, None,
     "evaluate --pretrain_path on the val set"),
    ("--domain_adaptation", str2bool, False, None,
     "adversarial GTA5 -> Cityscapes adaptation (reference train_DA)"),
    ("--momentum", float, 0.9, None, "DA: the generator's SGD momentum"),
    ("--weight_decay", float, 5e-4, None,
     "DA: the generator's SGD weight decay"),
    ("--lambda_adv_target1", float, 0.001, None,
     "DA: weight of the adversarial loss on the generator"),
    ("--aug_type", str, None, None,
     "GTA5 training augmentation: CS-HF | H-RP | B-GS-R (reference "
     "GTAV.py:42-46), on the device unless --host_augment True"),
    ("--depthwise", str2bool, False, None,
     "DA: depthwise-separable discriminator"),
    ("--batch_norm", str2bool, False, None,
     "DA: BatchNorm in the depthwise-separable discriminator"),
    ("--dtype", str, "bfloat16", ("bfloat16", "float32"),
     "compute dtype: bfloat16 = torch.autocast, float32 = no TF32"),
    ("--faithful_resize", str2bool, True, None,
     "reproduce the reference's PIL (h, w) transposition"),
    ("--augment_labels", str2bool, False, None,
     "warp the labels with the image (the reference leaves them)"),
    ("--fast_device_geometry", str2bool, False, None,
     "accepted and inert: the TPU's 3-shear rotation is not ported"),
    ("--host_augment", str2bool_auto, None, None,
     "True: --aug_type on the host (native C++, in the loader's threads); "
     "False or unset: on the device"),
    ("--sync_bn", str2bool, True, None,
     "data parallel: BN over the global batch (False = per-replica, "
     "DataParallel-faithful; single-process only)"),
    ("--num_devices", int, None, None,
     "data parallel over this many devices, one rank each: cards --cuda "
     "to --cuda + N - 1 (NCCL), or N CPU ranks under --cuda cpu (gloo)"),
    ("--spatial_devices", int, 1, None,
     "shard each image's height over this many of the --num_devices ranks "
     "(a data x spatial mesh, sync BN only, single-process only)"),
    ("--d_pretrain_path", str, "", None,
     "DA: discriminator .pth to start from (its kind must match)"),
    ("--d_head", int, 0, (0, 2),
     "DA: head fed to the discriminator (0 main, 2 out32)"),
    ("--da_step_mode", str, "interleaved", ("interleaved", "combined"),
     "DA: reference 4-phase step, or the NNI trial's accumulated one"),
    ("--nni_faithful_lr", str2bool, False, None,
     "DA: the NNI trial's LR dataflow (D never decays)"),
    ("--seed", int, 0, None, "seed of the random initial weights"),
    ("--ohem_threshold", float, 0.7, None, "--loss ohem threshold"),
    ("--ohem_keep_num", int, 65536, None, "--loss ohem keep count"),
    ("--use_fused_eval", str2bool, True, None,
     "fused upsample+argmax (the CUDA kernel on a CUDA device)"),
    ("--eval_scan_window", int, 0, None,
     "K > 1: evaluate K same-shaped batches per CUDA-graph replay (eager "
     "on the CPU)"),
    ("--quantize_int8", str2bool, False, None,
     "--domain_shift: int8 PTQ of the conv+BN+ReLU blocks before eval"),
    ("--calib_batches", int, 4, None,
     "--quantize_int8: val batches that calibrate the activation scales"),
    ("--quantize_filter", str, "head_ch", QUANTIZE_FILTERS,
     "--quantize_int8: the blocks quantized (ops/quantize.py::"
     "PRESET_FILTERS)"),
    ("--quantize_clip", str, "absmax", ("absmax", "p999"),
     "--quantize_int8: activation scale from the absmax or the 99.9th "
     "percentile"),
    ("--export_model", str, None, None,
     "--domain_shift: also write the serving artifact (torch.export, "
     "symbolic batch; utils/export.py) here"),
    ("--export_batches", str, None, None,
     "comma-separated batch sizes: write --export_model as a bundle of "
     "one program per size"),
    ("--export_spatial", str2bool, False, None,
     "with --export_devices N > 1: the height-sharded artifact (any batch, "
     "a band of rows a rank) in place of the batch-sharded one"),
    ("--export_devices", int, 1, None,
     "more than 1: an artifact served by that many ranks (serve.py "
     "--device a,b,...), the batch sharded over them"),
    ("--resume", str, None, None,
     "continue from <save_model_path>/state (model, optimizer, "
     "accumulation, epoch)"),
    ("--coordinator_address", str, None, None,
     "multi-process: the process group's host:port (or a tcp:// or "
     "file:// URL; or torchrun's MASTER_ADDR/MASTER_PORT)"),
    ("--num_processes", int, None, None,
     "multi-process: the process count, one rank each (or torchrun's "
     "WORLD_SIZE)"),
    ("--process_id", int, None, None,
     "multi-process: this process's rank (or torchrun's RANK)"),
    ("--eval_process_shard", str2bool, True, None,
     "data parallel: each rank evaluates its strided shard of the val set "
     "and the int64 counts are summed (False: every rank the whole set)"),
    ("--data_cache", str, None, None,
     "decode each dataset once into memmaps under this directory"),
    ("--jsonl_log", str, None, None, "per-epoch JSONL log file"),
    ("--tensorboard", str2bool, True, None,
     "TensorBoard scalars under runs/ (training)"),
    ("--profile_dir", str, None, None,
     "write a torch.profiler trace of the first training steps here"),
    ("--max_steps_per_epoch", int, None, None,
     "cap the steps of each epoch"),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="BiSeNet-STDC813 segmentation on PyTorch + CUDA "
                    "(port of dasemanticsegmentationaml_tpu: supervised "
                    "training, domain adaptation, --domain_shift "
                    "evaluation)")
    for flag, typ, default, choices, help_ in _FLAGS:
        p.add_argument(flag, type=typ, default=default, choices=choices,
                       help=help_)
    return p


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    args.ohem = ({"threshold": args.ohem_threshold,
                  "keep_num": args.ohem_keep_num}
                 if args.loss == "ohem" else None)
    return args
