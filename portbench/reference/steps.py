"""The reference's steps: plain PyTorch, fp32, TF32 off.

* ``train_steps``: the supervised step (reference train.py:63-120):
  the three heads upsampled with align_corners, ``F.cross_entropy(
  ignore_index=255)`` each, summed; SGD.

The steps return what the benchmark compares: the losses of each step,
the optimizer's state after the first step and the parameters after the
last. ``fp8_round`` is the control's precision.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import model as M

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
E4M3_MAX = 448.0
E5M2_MAX = 57344.0

@contextlib.contextmanager
def fp32_math():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _scaled_round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / top
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _FP8(torch.autograd.Function):
    """Forward: e4m3 with a per-tensor scale; backward: the gradient in
    e5m2, as fp8 training rounds its tensors."""

    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2, E5M2_MAX)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)


def build_g(state: Dict[str, torch.Tensor], device, rounding=None):
    g = M.BiSeNet(19).to(device)
    g.load_state_dict(state)
    return M.set_rounding(g.train(), rounding)


def normalise(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> normalised fp32 NCHW."""
    mean = torch.tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, device=images_u8.device)
    x = (images_u8.float() / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2).contiguous()


def seg_loss(g, images, labels):
    size = images.shape[2:]
    return sum(F.cross_entropy(M.upsample(f, size), labels, ignore_index=255)
               for f in g.features(images))


def _snapshot(optimizer, keys: Sequence[str]) -> List[Dict[str, torch.Tensor]]:
    return [{k: optimizer.state[p][k].detach().clone() for k in keys}
            for group in optimizer.param_groups for p in group["params"]]


def train_steps(state, batches, *, lr, momentum, weight_decay, device,
                rounding=None):
    """The supervised steps on ``batches`` [(uint8 images, trainIds)]
    from ``state``: {"losses": [[loss]], "opt1": [{"momentum_buffer"}]
    of the trainable parameters after step 1, "params": the trainable
    parameters after the last, "names": their names}."""
    with fp32_math():
        g = build_g(state, device, rounding)
        params = M.trainable(g)
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                              weight_decay=weight_decay, foreach=False)
        losses, opt1 = [], None
        for images_u8, labels in batches:
            images = normalise(images_u8.to(device))
            opt.zero_grad(set_to_none=True)
            loss = seg_loss(g, images, labels.to(device).long())
            loss.backward()
            opt.step()
            losses.append([float(loss.detach())])
            if opt1 is None:
                opt1 = _snapshot(opt, ("momentum_buffer",))
        return {"losses": losses, "opt1": opt1,
                "params": [p.detach().clone() for p in params],
                "names": [n for n, _ in g.named_parameters()
                          if not n.startswith(M.DEAD_PREFIXES)]}
