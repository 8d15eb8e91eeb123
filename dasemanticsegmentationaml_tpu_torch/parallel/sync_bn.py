"""BatchNorm over the global batch of a process group (``--sync_bn True``).

The JAX package's ``sync_bn=True`` step is one program over the global
batch, so every BN layer normalises with the statistics of all the
devices' rows (JAX parallel/mesh.py:195-209; ops/norm.py:76-97 with
``axis_name``). Here each rank holds its rows, and a train-mode BN layer
joins the ranks' statistics with one ``all_reduce``:

* forward: each rank's per-channel sum and sum of squares and its element
  count, in fp32 (fp64 for an fp64 input), summed over the group; ``mean = sum / n`` and
  ``var = max(sumsq / n - mean^2, 0)`` (JAX norm.py:77-82); the running
  statistics move as ``nn.BatchNorm2d``'s do, the variance unbiased by
  the global count ``n / (n - 1)`` (norm.py:85-97), with the same momentum;
* backward: ``sum(dy)`` and ``sum(dy * x_hat)`` summed over the group, so
  that each rank's input gradient is that of the global normalisation;
  the weight and bias gradients stay each rank's share, summed with the
  other parameters' gradients by the step (``parallel/mesh.py``).

``torch.nn.SyncBatchNorm`` is the library's form of this function, but
its forward refuses CPU tensors, so it could not be held against JAX on
the CPU; the CPU and the card run this one implementation. In eval mode
the layer is ``nn.BatchNorm2d`` (the running statistics), so a converted
model evaluates, exports and saves as before: the class, the state dict
and the ``isinstance`` checks of the BN fold (``ops/norm.py``,
``ops/quantize.py``) are ``nn.BatchNorm2d``'s.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn

_DIMS = (0, 2, 3)


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(1, -1, 1, 1)


class SyncBatchNormFunction(torch.autograd.Function):
    """Train-mode BN over the group's global batch (module docstring)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, group):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        c = x.shape[1]
        stats = torch.cat([
            xf.sum(_DIMS), (xf * xf).sum(_DIMS),
            torch.full((1,), float(x.numel() // c), dtype=xf.dtype,
                       device=x.device)])
        dist.all_reduce(stats, group=group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp_min(stats[c:2 * c] / n - mean * mean, 0.0)
        invstd = torch.rsqrt(var + eps)
        with torch.no_grad():
            running_mean.mul_(1.0 - momentum).add_(mean * momentum)
            running_var.mul_(1.0 - momentum).add_(
                var * (n / torch.clamp_min(n - 1.0, 1.0)) * momentum)
        y = (xf - _per_channel(mean)) * _per_channel(invstd * weight) \
            + _per_channel(bias)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        dyf = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - _per_channel(mean)) \
            * _per_channel(invstd)
        sums = torch.cat([dyf.sum(_DIMS), (dyf * xhat).sum(_DIMS)])
        grad_weight = sums[c:].clone() if ctx.needs_input_grad[1] else None
        grad_bias = sums[:c].clone() if ctx.needs_input_grad[2] else None
        grad_x = None
        if ctx.needs_input_grad[0]:
            dist.all_reduce(sums, group=ctx.group)
            mean_dy = sums[:c] / n
            mean_dy_xhat = sums[c:] / n
            grad_x = (dyf - _per_channel(mean_dy)
                      - xhat * _per_channel(mean_dy_xhat)) \
                * _per_channel(weight * invstd)
            grad_x = grad_x.to(x.dtype)
        return grad_x, grad_weight, grad_bias, None, None, None, None, None


class SyncBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics are the group's
    (``SyncBatchNormFunction``); ``group`` None is the default group."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, group=None, device=None, dtype=None):
        super().__init__(num_features, eps=eps, momentum=momentum,
                         device=device, dtype=dtype)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        return SyncBatchNormFunction.apply(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            self.eps, self.momentum, self.group)


def convert_sync_batchnorm(module: nn.Module, group=None) -> nn.Module:
    """Replace, in place, every ``nn.BatchNorm2d`` under ``module`` by a
    ``SyncBatchNorm2d`` holding the same parameter and buffer tensors (an
    optimizer built before keeps its references); returns ``module``.
    Layers already converted are left as they are."""
    for name, child in list(module.named_children()):
        if type(child) is nn.BatchNorm2d:
            if not (child.affine and child.track_running_stats
                    and child.momentum is not None):
                raise ValueError(f"{name}: only affine BN with running "
                                 "statistics and a momentum is synced")
            sync = SyncBatchNorm2d(child.num_features, child.eps,
                                   child.momentum, group=group,
                                   device="meta")
            sync.weight, sync.bias = child.weight, child.bias
            for buf in ("running_mean", "running_var",
                        "num_batches_tracked"):
                sync._buffers[buf] = child._buffers[buf]
            sync.train(child.training)
            setattr(module, name, sync)
        else:
            convert_sync_batchnorm(child, group)
    return module

