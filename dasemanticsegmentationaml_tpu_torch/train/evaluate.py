"""Evaluation (reference train.py:24-61 ``val``) on the device.

Counterpart of ``dasemanticsegmentationaml_tpu/train/evaluate.py``. Per
batch: ``features`` -> the fused upsample+argmax kernel -> int32
predictions -> the confusion matrix and the correct-pixel count, all
accumulated as int64 on the device and read back once at the end. IoU is
computed on the host in float64 by ``ops/metrics.py::per_class_iou`` (JAX
evaluate.py:246-257; reference utils.py:170-172). The JAX module's fp32
flush windows and its
``lax.scan`` dispatch exist for a TPU's integer-exact range and round
trips; int64 counters need neither.

Faithful metric semantics:
* mIoU drops pixels labelled outside [0, C) (reference utils.py:161-167);
* 'precision' counts ignore pixels as wrong (utils.py:151-159), averaged
  per image (train.py:52-54), which at a fixed image size is the pixel
  mean accumulated here.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.cuda.upsample_argmax import upsample_argmax
from ..ops.metrics import confusion_matrix, per_class_iou


def predict(model, images: torch.Tensor, use_fused_kernel: bool,
            amp_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NCHW images -> (B, H, W) int32 trainIds (JAX evaluate.py:38-46).

    use_fused_kernel: the main head's stride-8 logits go through
    ``upsample_argmax`` (the CUDA kernel on a CUDA tensor); otherwise the
    full forward upsamples all three heads and argmax picks from the main
    one. amp_dtype: run the model under ``torch.autocast`` in that dtype
    (bf16), with BN kept in fp32."""
    autocast = (torch.autocast(images.device.type, dtype=amp_dtype)
                if amp_dtype is not None else contextlib.nullcontext())
    with autocast:
        if use_fused_kernel:
            feat, _f16, _f32 = model.features(images)
        else:
            out, _out16, _out32 = model(images)
    if use_fused_kernel:
        return upsample_argmax(feat.contiguous(), images.shape[2:])
    return out.argmax(1).to(torch.int32)


def evaluate(model, loader, num_classes: int, *,
             prepare: Callable[[Tuple], Tuple[torch.Tensor, torch.Tensor]],
             device: torch.device, use_fused_kernel: bool = True,
             amp_dtype: Optional[torch.dtype] = None,
             print_results: bool = True) -> Tuple[float, float]:
    """Whole-dataset eval; returns (precision, miou) like reference val()
    (JAX evaluate.py:133-258)."""
    hist = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                       device=device)
    correct = torch.zeros((), dtype=torch.int64, device=device)
    total = 0
    with torch.inference_mode():
        for batch in loader:
            images, labels = prepare(batch)
            pred = predict(model, images, use_fused_kernel, amp_dtype)
            hist += confusion_matrix(labels, pred, num_classes)
            correct += (pred == labels).sum()
            total += pred.numel()
    precision = int(correct.item()) / max(total, 1)
    miou_list = per_class_iou(hist.cpu()).numpy()
    miou = float(np.mean(miou_list))
    if print_results:
        print("precision per pixel for test: %.3f" % precision)
        print("mIoU for validation: %.3f" % miou)
        print(f"mIoU per class: {miou_list}")
    return precision, miou
