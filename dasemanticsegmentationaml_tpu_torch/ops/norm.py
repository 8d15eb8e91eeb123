"""Folding an inference-mode BatchNorm into the convolution before it.

Counterpart of ``dasemanticsegmentationaml_tpu/ops/norm.py::
fold_bn_into_conv`` (:104-123), in PyTorch's OIHW weight layout. The
port's training and eval BN is stock ``nn.BatchNorm2d``; only the fused
CatBottleneck kernel (``ops/cuda/fused_stdc.py``) takes folded weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def fold_bn_into_conv(weight: torch.Tensor, conv_bias: Optional[torch.Tensor],
                      bn_weight: torch.Tensor, bn_bias: torch.Tensor,
                      running_mean: torch.Tensor, running_var: torch.Tensor,
                      eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Given ``y = BN(conv(x, weight) + conv_bias)`` in eval mode, return
    ``(weight', bias')`` with ``y = conv(x, weight') + bias'``.

    ``weight`` is OIHW; the BN tensors are per output channel. Computed in
    the dtype of ``weight`` (fp32 for the kernel's folding)."""
    inv = bn_weight / torch.sqrt(running_var + eps)
    weight_f = weight * inv.reshape((-1,) + (1,) * (weight.dim() - 1))
    b = conv_bias if conv_bias is not None else 0.0
    bias_f = (b - running_mean) * inv + bn_bias
    return weight_f, bias_f
