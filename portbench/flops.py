"""Convolution and linear FLOPs of one step, counted on the reference.

A forward of the reference model on meta tensors (shapes only, no
memory, no arithmetic) with a hook on every ``nn.Conv2d`` and
``nn.Linear``: each adds 2 x (its output's elements) x (the multiply-adds
one output element takes: in-channels / groups x kernel area, or the
linear's in-features). BN, activations, pooling, the resizes and the
losses are left out: they are not matrix work, and the device's peak
that ``mfu`` divides by is the tensor cores' bf16 rate.

A training step counts its forward and twice it for the backward (the
input's and the weight's gradients).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn as nn

from .reference import model as M


def forward_flops(module: nn.Module, shape: Tuple[int, ...],
                  call=None) -> int:
    total = 0

    def hook(m, _inputs, out):
        nonlocal total
        if isinstance(m, nn.Conv2d):
            per = m.in_channels // m.groups * m.kernel_size[0] \
                * m.kernel_size[1]
        else:
            per = m.in_features
        total += 2 * out.numel() * per

    module.eval()
    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.no_grad():
            x = torch.empty(shape, device="meta")
            (call or module)(x)
    finally:
        for h in handles:
            h.remove()
    return total


@functools.lru_cache(maxsize=None)
def g_forward(batch: int, hw: Tuple[int, int]) -> int:
    """G's forward to its three heads (``features``) on (batch, 3, *hw)."""
    with torch.device("meta"):
        g = M.BiSeNet(19)
    return forward_flops(g, (batch, 3, *hw), g.features)


def train_step(batch: int, hw: Tuple[int, int]) -> int:
    return 3 * g_forward(batch, tuple(hw))
