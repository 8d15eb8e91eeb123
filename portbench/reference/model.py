"""Plain PyTorch BiSeNet-STDC813.

The benchmark's own copy of the model, frozen: the layer equations of
the STDC-Seg paper's BiSeNet with the STDCNet813 backbone (Fan et al.,
CVPR 2021; reference ``model/model_stages.py`` and ``model/stdcnet.py``),
in stock ``torch.nn`` modules with no custom kernel. Attribute names give the reference's
state-dict keys, so one state dict loads into this model and into the
program's.

Every convolution is a ``Conv``: ``F.conv2d`` of its input and weight
after ``rounding`` (None: as they are). The benchmark's control sets it
to fp8 rounding (``reference/steps.py::fp8_round``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv(nn.Conv2d):
    """``nn.Conv2d`` whose input, weight and output pass ``rounding``, as
    autocast runs a convolution in its lower precision."""

    rounding = None

    def forward(self, x):
        if self.rounding is None:
            return super().forward(x)
        r = self.rounding
        return r(self._conv_forward(r(x), r(self.weight), self.bias))


def set_rounding(model: nn.Module, rounding) -> nn.Module:
    for m in model.modules():
        if isinstance(m, Conv):
            m.rounding = rounding
    return model


def _bn(c):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class ConvX(nn.Module):
    """conv(k, s, pad k//2, no bias) + BN + ReLU (stdcnet.py:6-15)."""

    def __init__(self, cin, cout, k=3, s=1):
        super().__init__()
        self.conv = Conv(cin, cout, k, s, k // 2, bias=False)
        self.bn = _bn(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class CatBottleneck(nn.Module):
    """stdcnet.py:66-113, block_num 4."""

    def __init__(self, cin, cout, stride):
        super().__init__()
        self.stride = stride
        chans = [(cin, cout // 2, 1), (cout // 2, cout // 4, 3),
                 (cout // 4, cout // 8, 3), (cout // 8, cout // 8, 3)]
        self.conv_list = nn.ModuleList(ConvX(i, o, k) for i, o, k in chans)
        if stride == 2:
            half = cout // 2
            self.avd_layer = nn.Sequential(
                Conv(half, half, 3, 2, 1, groups=half, bias=False), _bn(half))
            self.skip = nn.AvgPool2d(3, 2, 1)

    def forward(self, x):
        out1 = self.conv_list[0](x)
        out = out1
        outs = []
        for i, conv in enumerate(self.conv_list[1:]):
            out = conv(self.avd_layer(out1) if i == 0 and self.stride == 2
                       else out)
            outs.append(out)
        head = self.skip(out1) if self.stride == 2 else out1
        return torch.cat([head] + outs, dim=1)


class STDCNet813(nn.Module):
    """stdcnet.py:116-204 with layers [2, 2, 2], base 64; the ImageNet
    head (conv_last, fc, bn, linear) is held for its state-dict keys and
    never run."""

    def __init__(self):
        super().__init__()
        feats = [ConvX(3, 32, 3, 2), ConvX(32, 64, 3, 2),
                 CatBottleneck(64, 256, 2), CatBottleneck(256, 256, 1),
                 CatBottleneck(256, 512, 2), CatBottleneck(512, 512, 1),
                 CatBottleneck(512, 1024, 2), CatBottleneck(1024, 1024, 1)]
        self.features = nn.Sequential(*feats)
        self.conv_last = ConvX(1024, 1024, 1, 1)
        self.fc = nn.Linear(1024, 1024, bias=False)
        self.bn = nn.BatchNorm1d(1024)
        self.linear = nn.Linear(1024, 1000, bias=False)

    def forward(self, x):
        f = self.features
        feat2 = f[0](x)
        feat4 = f[1](feat2)
        feat8 = f[3](f[2](feat4))
        feat16 = f[5](f[4](feat8))
        feat32 = f[7](f[6](feat16))
        return feat2, feat4, feat8, feat16, feat32


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k=3, s=1, p=1):
        super().__init__()
        self.conv = Conv(cin, cout, k, s, p, bias=False)
        self.bn = _bn(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BiSeNetOutput(nn.Module):
    def __init__(self, cin, mid, n_classes):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid)
        self.conv_out = Conv(mid, n_classes, 1, bias=False)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class AttentionRefinementModule(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout)
        self.conv_atten = Conv(cout, cout, 1, bias=False)
        self.bn_atten = _bn(cout)

    def forward(self, x):
        feat = self.conv(x)
        atten = feat.mean(dim=(2, 3), keepdim=True)
        return feat * torch.sigmoid(self.bn_atten(self.conv_atten(atten)))


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = STDCNet813()
        self.arm16 = AttentionRefinementModule(512, 128)
        self.arm32 = AttentionRefinementModule(1024, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(1024, 128, 1, 1, 0)

    def forward(self, x):
        _f2, _f4, feat8, feat16, feat32 = self.backbone(x)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        avg_up = avg.expand(-1, -1, *feat32.shape[2:])
        feat32_sum = self.arm32(feat32) + avg_up
        feat32_up = self.conv_head32(
            F.interpolate(feat32_sum, size=feat16.shape[2:], mode="nearest"))
        feat16_sum = self.arm16(feat16) + feat32_up
        feat16_up = self.conv_head16(
            F.interpolate(feat16_sum, size=feat8.shape[2:], mode="nearest"))
        return feat8, feat16_up, feat32_up


class FeatureFusionModule(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.convblk = ConvBNReLU(cin, cout, 1, 1, 0)
        self.conv1 = Conv(cout, cout // 4, 1, bias=False)
        self.conv2 = Conv(cout // 4, cout, 1, bias=False)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = feat.mean(dim=(2, 3), keepdim=True)
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(atten))))
        return feat * atten + feat


class BiSeNet(nn.Module):
    """model_stages.py:205-244, use_conv_last False. ``features``: the
    heads (out, out16, out32) at strides 8, 8 and 16; ``forward``: each
    upsampled to the input size with align_corners=True."""

    def __init__(self, n_classes=19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusionModule(384, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes)

    def features(self, x):
        feat8, feat_cp8, feat_cp16 = self.cp(x)
        fuse = self.ffm(feat8, feat_cp8)
        return (self.conv_out(fuse), self.conv_out16(feat_cp8),
                self.conv_out32(feat_cp16))

    def forward(self, x):
        return tuple(upsample(f, x.shape[2:]) for f in self.features(x))


def upsample(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


#: G's parameters that a segmentation step never reaches (the ImageNet
#: head), left out of its optimizer as the reference's unused parameters
DEAD_PREFIXES = ("cp.backbone.conv_last.", "cp.backbone.fc.",
                 "cp.backbone.bn.", "cp.backbone.linear.")


def trainable(model: nn.Module):
    return [p for n, p in model.named_parameters()
            if not n.startswith(DEAD_PREFIXES)]
