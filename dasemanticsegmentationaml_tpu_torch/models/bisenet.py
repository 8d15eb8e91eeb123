"""BiSeNet context path + segmentation heads, PyTorch, NCHW.

Counterpart of ``dasemanticsegmentationaml_tpu/models/bisenet.py``, after
reference model/model_stages.py:

* ``ConvBNReLU``                (JAX bisenet.py:36; reference :11-35)
* ``BiSeNetOutput``             (JAX :77; reference :38-65)
* ``AttentionRefinementModule`` (JAX :100; reference :68-91): 3x3
  ConvBNReLU, global mean, 1x1 conv, BN, sigmoid gate
* ``ContextPath``               (JAX :130-175; reference :94-152)
* ``FeatureFusionModule``       (JAX :178-210; reference :155-202):
  ``feat * atten + feat``
* ``BiSeNet``                   (JAX :213-257; reference :205-270):
  ``features`` gives the three heads at strides 8, 8 and 16;
  ``forward`` upsamples them to the input size with align_corners=True.

``build_bisenet`` makes a model with seeded weights from a
``torch.Generator``, drawn on the CPU so that every device gets the same
numbers.

The height-sharded mesh (``parallel/spatial.py``) swaps three named
functions per instance: ``mean_hw`` (the global means of ARM, the context
path and FFM), ``upsample`` (the context path's nearest upsample) and
``resize`` (``forward``'s align_corners resize).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.quantize import QuantBlock, check_quant_mode
from ..ops.resize import resize_bilinear_align_corners, upsample_nearest
from .stdcnet import STDCNet813, _bn

BACKBONES = ("STDCNet813", "CatmodelSmall", "CatNetSmall", "STDC1")


class ConvBNReLU(QuantBlock):
    """conv(ks, stride, pad) no-bias + BN + ReLU (reference
    model_stages.py:11-29), with the int8 PTQ modes of
    ``ops/quantize.py::QuantBlock`` (JAX bisenet.py:36-76)."""

    def __init__(self, in_chan: int, out_chan: int, ks: int = 3,
                 stride: int = 1, padding: int = 1, device=None,
                 quant_mode: str = "off"):
        super().__init__()
        self.conv = nn.Conv2d(in_chan, out_chan, ks, stride=stride,
                              padding=padding, bias=False, device=device)
        self.bn = _bn(out_chan, device)
        self.quant_mode = check_quant_mode(quant_mode)


class BiSeNetOutput(nn.Module):
    """3x3 ConvBNReLU + 1x1 no-bias classifier conv (reference
    model_stages.py:38-48)."""

    def __init__(self, in_chan: int, mid_chan: int, n_classes: int,
                 device=None):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, mid_chan, 3, 1, 1, device=device)
        self.conv_out = nn.Conv2d(mid_chan, n_classes, 1, bias=False,
                                  device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.conv(x))


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """The global average over H and W, kept as (B, C, 1, 1)."""
    return x.mean(dim=(2, 3), keepdim=True)


class AttentionRefinementModule(nn.Module):
    """Channel attention (reference model_stages.py:68-85)."""

    mean_hw = staticmethod(mean_hw)

    def __init__(self, in_chan: int, out_chan: int, device=None):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, out_chan, 3, 1, 1, device=device)
        self.conv_atten = nn.Conv2d(out_chan, out_chan, 1, bias=False,
                                    device=device)
        self.bn_atten = _bn(out_chan, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv(x)
        atten = self.mean_hw(feat)
        atten = torch.sigmoid(self.bn_atten(self.conv_atten(atten)))
        return feat * atten


class ContextPath(nn.Module):
    """Backbone + ARM pyramid + global context (reference
    model_stages.py:94-135; the reference ignores the backbone argument,
    :98, so only the STDC1 family is accepted)."""

    mean_hw = staticmethod(mean_hw)
    upsample = staticmethod(upsample_nearest)

    def __init__(self, backbone_name: str = "STDCNet813",
                 use_conv_last: bool = False, device=None):
        super().__init__()
        if backbone_name not in BACKBONES:
            raise ValueError(f"unsupported backbone {backbone_name}")
        self.backbone = STDCNet813(use_conv_last=use_conv_last, device=device)
        self.arm16 = AttentionRefinementModule(512, 128, device=device)
        self.arm32 = AttentionRefinementModule(1024, 128, device=device)
        self.conv_head32 = ConvBNReLU(128, 128, 3, 1, 1, device=device)
        self.conv_head16 = ConvBNReLU(128, 128, 3, 1, 1, device=device)
        self.conv_avg = ConvBNReLU(1024, 128, 1, 1, 0, device=device)

    def forward(self, x: torch.Tensor):
        feat2, feat4, feat8, feat16, feat32 = self.backbone(x)
        h8, w8 = feat8.shape[2:]
        h16, w16 = feat16.shape[2:]
        h32, w32 = feat32.shape[2:]

        avg = self.conv_avg(self.mean_hw(feat32))
        avg_up = self.upsample(avg, (h32, w32))

        feat32_sum = self.arm32(feat32) + avg_up
        feat32_up = self.upsample(feat32_sum, (h16, w16))
        feat32_up = self.conv_head32(feat32_up)

        feat16_sum = self.arm16(feat16) + feat32_up
        feat16_up = self.upsample(feat16_sum, (h8, w8))
        feat16_up = self.conv_head16(feat16_up)

        return feat2, feat4, feat8, feat16, feat16_up, feat32_up


class FeatureFusionModule(nn.Module):
    """Concat spatial + context, 1x1 ConvBNReLU, SE-style gate + residual
    (reference model_stages.py:155-185)."""

    mean_hw = staticmethod(mean_hw)

    def __init__(self, in_chan: int, out_chan: int, device=None):
        super().__init__()
        self.convblk = ConvBNReLU(in_chan, out_chan, 1, 1, 0, device=device)
        self.conv1 = nn.Conv2d(out_chan, out_chan // 4, 1, bias=False,
                               device=device)
        self.conv2 = nn.Conv2d(out_chan // 4, out_chan, 1, bias=False,
                               device=device)

    def forward(self, fsp: torch.Tensor, fcp: torch.Tensor) -> torch.Tensor:
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = self.mean_hw(feat)
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(atten))))
        return feat * atten + feat


class BiSeNet(nn.Module):
    """Full segmentation network (reference model_stages.py:205-244).

    ``forward`` returns the three upsampled heads (out, out16, out32) as
    NCHW logits, in the reference's order; ``features`` returns them
    before upsampling, for the fused eval kernel."""

    resize = staticmethod(resize_bilinear_align_corners)

    def __init__(self, n_classes: int, backbone_name: str = "STDCNet813",
                 use_conv_last: bool = False, device=None):
        super().__init__()
        self.cp = ContextPath(backbone_name, use_conv_last, device=device)
        self.ffm = FeatureFusionModule(256 + 128, 256, device=device)
        self.conv_out = BiSeNetOutput(256, 256, n_classes, device=device)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes, device=device)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes, device=device)

    def features(self, x: torch.Tensor):
        """Head logits at their native strides (1/8, 1/8, 1/16)."""
        _f2, _f4, feat_res8, _f16, feat_cp8, feat_cp16 = self.cp(x)
        feat_fuse = self.ffm(feat_res8, feat_cp8)
        return (self.conv_out(feat_fuse), self.conv_out16(feat_cp8),
                self.conv_out32(feat_cp16))

    def forward(self, x: torch.Tensor):
        hw = x.shape[2:]
        return tuple(self.resize(f, hw) for f in self.features(x))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights, drawn on the CPU from ``generator`` and copied to
    the model's device: He-normal conv and linear weights; BN affine and
    running statistics near identity but not equal to it, so that a test
    sees them."""
    def draw(shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=generator) * scale + shift

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(draw(m.weight.shape, math.sqrt(2.0 / fan_in)))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            c = m.num_features
            m.weight.copy_(draw((c,), 0.1, 1.0))
            m.bias.copy_(draw((c,), 0.1))
            m.running_mean.copy_(draw((c,), 0.1))
            m.running_var.copy_(
                torch.rand((c,), generator=generator) + 0.5)
            m.num_batches_tracked.zero_()


#: the backbone's ImageNet head, which segmentation never runs
_IMAGENET_HEAD = ("fc", "bn", "linear")


def trainable_parameters(model: BiSeNet, use_conv_last: bool = False):
    """The parameters a segmentation step updates: all but the backbone's
    ImageNet head (``cp.backbone.fc/bn/linear``, and ``conv_last`` unless
    ``use_conv_last``), which gets no gradient (JAX bisenet.py:276-296
    ``unused_param_mask``; torch skips parameters whose grad is None)."""
    dead = _IMAGENET_HEAD + (() if use_conv_last else ("conv_last",))
    prefixes = tuple(f"cp.backbone.{name}." for name in dead)
    return [p for name, p in model.named_parameters()
            if not name.startswith(prefixes)]


def build_bisenet(n_classes: int, *, device, generator: torch.Generator,
                  backbone_name: str = "STDCNet813",
                  use_conv_last: bool = False) -> BiSeNet:
    """A BiSeNet on ``device`` in eval mode, with seeded weights."""
    with torch.device("meta"):
        model = BiSeNet(n_classes, backbone_name, use_conv_last)
    model = model.to_empty(device=device)
    init_weights(model, generator)
    return model.eval()
