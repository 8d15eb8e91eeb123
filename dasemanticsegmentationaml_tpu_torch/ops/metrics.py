"""Segmentation metrics on the device, exact integer counts.

Counterpart of ``dasemanticsegmentationaml_tpu/ops/metrics.py``. There the
confusion matrix is an fp32 one-hot einsum, chunked to stay below the fp32
integer-exact bound (metrics.py:31-87); here it is one int64
``torch.bincount``, exact at any batch size.

Semantics (reference utils.py:151-172):
* ``confusion_matrix(labels, preds)`` is ``fast_hist``: hist[label, pred],
  pixels whose label lies outside [0, C) (the 255 ignore label) dropped;
* ``global_pixel_accuracy`` is ``compute_global_accuracy``: ignore pixels
  count as wrong, the reference's quirk; ``global_pixel_accuracy_masked``
  is the corrected variant.
"""

from __future__ import annotations

import torch


def confusion_matrix(labels: torch.Tensor, preds: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(C, C) int64 hist[label, pred] (JAX metrics.py:51). A pixel counts
    when its label and its prediction both lie in [0, C)."""
    labels = labels.reshape(-1).long()
    preds = preds.reshape(-1).long()
    valid = ((labels >= 0) & (labels < num_classes)
             & (preds >= 0) & (preds < num_classes))
    n = num_classes * num_classes
    idx = torch.where(valid, labels * num_classes + preds, n)
    return torch.bincount(idx, minlength=n + 1)[:n].reshape(
        num_classes, num_classes)


def per_class_iou(hist: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """Per-class IoU (JAX metrics.py:90; reference utils.py:170-172)."""
    hist = hist.double() if not hist.is_floating_point() else hist
    diag = torch.diagonal(hist)
    return diag / (hist.sum(dim=1) + hist.sum(dim=0) - diag + epsilon)


def global_pixel_accuracy(labels: torch.Tensor,
                          preds: torch.Tensor) -> torch.Tensor:
    """Reference-faithful accuracy: ignore pixels count as wrong (JAX
    metrics.py:96; reference utils.py:151-159)."""
    return (labels.reshape(-1) == preds.reshape(-1)).float().mean()


def global_pixel_accuracy_masked(labels: torch.Tensor, preds: torch.Tensor,
                                 num_classes: int) -> torch.Tensor:
    """Accuracy over non-ignored pixels only (JAX metrics.py:103)."""
    labels = labels.reshape(-1)
    preds = preds.reshape(-1)
    valid = (labels >= 0) & (labels < num_classes)
    correct = ((labels == preds) & valid).sum().float()
    return correct / valid.sum().float().clamp(min=1.0)
