"""STDC backbone (STDC1 / "813" configuration), PyTorch, NCHW.

Counterpart of ``dasemanticsegmentationaml_tpu/models/stdcnet.py``, after
reference model/stdcnet.py:

* ``ConvX``         -- conv(k, s, pad=k//2, no bias) + BN + ReLU
                       (JAX stdcnet.py:101; reference stdcnet.py:6-15)
* ``CatBottleneck`` -- 1x1 entry conv, then channel-halving 3x3 convs whose
                       outputs are concatenated; at stride 2 a depthwise
                       3x3 s2 + BN ``avd_layer`` and an
                       ``AvgPool2d(3, 2, 1)`` skip (count_include_pad=True)
                       (JAX stdcnet.py:162; reference stdcnet.py:66-113)
* ``AddBottleneck`` -- the same chain summed with a (strided) skip
                       projection (JAX stdcnet.py:208; reference
                       stdcnet.py:17-64)
* ``STDCNet813``    -- two stride-2 ConvX + the bottleneck groups, five
                       feature maps at strides 2..32 (JAX stdcnet.py:263;
                       reference stdcnet.py:116-204), plus the ImageNet
                       head (conv_last / fc / bn / linear) so the
                       reference's ``.tar`` keys load 1:1.

Attribute names give exactly the reference state-dict keys that
``utils/torch_io.py::variables_to_torch_state`` emits (for example
``features.2.avd_layer.0.weight``, ``features.3.skip.2.weight``). BN is
``nn.BatchNorm2d(eps=1e-5, momentum=0.1)``, which is what the JAX
``ops/norm.py::BatchNorm`` (:35-101) rebuilds; under bf16 autocast it
computes in fp32 (norm.py:16-18).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.quantize import QuantBlock, check_quant_mode


def _conv(in_c: int, out_c: int, kernel: int, stride: int = 1,
          groups: int = 1, device=None) -> nn.Conv2d:
    return nn.Conv2d(in_c, out_c, kernel, stride=stride, padding=kernel // 2,
                     groups=groups, bias=False, device=device)


def _bn(c: int, device=None) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1, device=device)


class ConvX(QuantBlock):
    """conv-BN-ReLU block (JAX stdcnet.py:101; reference stdcnet.py:6-15).

    ``quant_mode`` (int8 PTQ, ``ops/quantize.py::QuantBlock``): "off" is
    the parity path; "calib" records the input's absmax in eval mode;
    "int8" runs the folded s8 x s8 -> s32 conv and its fp32 epilogue (eval
    only)."""

    def __init__(self, in_planes: int, out_planes: int, kernel: int = 3,
                 stride: int = 1, device=None, quant_mode: str = "off"):
        super().__init__()
        self.conv = _conv(in_planes, out_planes, kernel, stride, device=device)
        self.bn = _bn(out_planes, device)
        self.quant_mode = check_quant_mode(quant_mode)


def _chain_channels(in_planes: int, out_planes: int,
                    block_num: int) -> List[Tuple[int, int]]:
    """(in, out) channels of conv_list[i] (JAX stdcnet.py:139; reference
    stdcnet.py:81-92)."""
    chans = []
    for idx in range(block_num):
        if idx == 0:
            chans.append((in_planes, out_planes // 2))
        elif idx == 1 and block_num == 2:
            chans.append((out_planes // 2, out_planes // 2))
        elif idx == 1 and block_num > 2:
            chans.append((out_planes // 2, out_planes // 4))
        elif idx < block_num - 1:
            chans.append((out_planes // int(math.pow(2, idx)),
                          out_planes // int(math.pow(2, idx + 1))))
        else:
            chans.append((out_planes // int(math.pow(2, idx)),
                          out_planes // int(math.pow(2, idx))))
    return chans


def _conv_list(in_planes: int, out_planes: int, block_num: int,
               device) -> nn.ModuleList:
    if block_num <= 1:
        raise ValueError("block number should be larger than 1.")
    return nn.ModuleList(
        ConvX(i, o, kernel=1 if idx == 0 else 3, device=device)
        for idx, (i, o) in enumerate(
            _chain_channels(in_planes, out_planes, block_num)))


class CatBottleneck(nn.Module):
    """STDC concat bottleneck (JAX stdcnet.py:162; reference
    stdcnet.py:66-113). At stride 2 the downsample sits in ``avd_layer``
    and the entry branch is average-pooled."""

    def __init__(self, in_planes: int, out_planes: int, block_num: int = 3,
                 stride: int = 1, device=None):
        super().__init__()
        self.stride = stride
        self.conv_list = _conv_list(in_planes, out_planes, block_num, device)
        if stride == 2:
            half = out_planes // 2
            self.avd_layer = nn.Sequential(
                _conv(half, half, 3, 2, groups=half, device=device),
                _bn(half, device))
            self.skip = nn.AvgPool2d(kernel_size=3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv_list[0](x)
        outs = []
        out = out1
        for idx, conv in enumerate(self.conv_list[1:]):
            if idx == 0 and self.stride == 2:
                out = conv(self.avd_layer(out1))
            else:
                out = conv(out)
            outs.append(out)
        head = self.skip(out1) if self.stride == 2 else out1
        return torch.cat([head] + outs, dim=1)


class AddBottleneck(nn.Module):
    """STDC residual bottleneck (JAX stdcnet.py:208; reference
    stdcnet.py:17-64). At stride 2 the skip is depthwise 3x3 s2 + BN +
    1x1 projection + BN."""

    def __init__(self, in_planes: int, out_planes: int, block_num: int = 3,
                 stride: int = 1, device=None):
        super().__init__()
        self.stride = stride
        self.conv_list = _conv_list(in_planes, out_planes, block_num, device)
        if stride == 2:
            half = out_planes // 2
            self.avd_layer = nn.Sequential(
                _conv(half, half, 3, 2, groups=half, device=device),
                _bn(half, device))
            self.skip = nn.Sequential(
                _conv(in_planes, in_planes, 3, 2, groups=in_planes,
                      device=device),
                _bn(in_planes, device),
                _conv(in_planes, out_planes, 1, device=device),
                _bn(out_planes, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        out = x
        for idx, conv in enumerate(self.conv_list):
            out = conv(out)
            if idx == 0 and self.stride == 2:
                out = self.avd_layer(out)
            outs.append(out)
        if self.stride == 2:
            x = self.skip(x)
        return torch.cat(outs, dim=1) + x


class STDCNet813(nn.Module):
    """STDC1 backbone, "813" config (JAX stdcnet.py:263; reference
    stdcnet.py:116-204). ``base``, ``layers``, ``block_num`` and
    ``block_type`` build narrower or other variants."""

    def __init__(self, base: int = 64, layers: Sequence[int] = (2, 2, 2),
                 block_num: int = 4, block_type: str = "cat",
                 num_classes: int = 1000, dropout: float = 0.20,
                 use_conv_last: bool = False, device=None):
        super().__init__()
        if block_type not in ("cat", "add"):
            raise ValueError(f"unknown block type {block_type}")
        block = CatBottleneck if block_type == "cat" else AddBottleneck
        self.use_conv_last = use_conv_last
        feats = [ConvX(3, base // 2, 3, 2, device=device),
                 ConvX(base // 2, base, 3, 2, device=device)]
        # reference stdcnet.py:174-181
        for i, layer in enumerate(layers):
            for j in range(layer):
                if i == 0 and j == 0:
                    feats.append(block(base, base * 4, block_num, 2,
                                       device=device))
                elif j == 0:
                    feats.append(block(base * int(math.pow(2, i + 1)),
                                       base * int(math.pow(2, i + 2)),
                                       block_num, 2, device=device))
                else:
                    feats.append(block(base * int(math.pow(2, i + 2)),
                                       base * int(math.pow(2, i + 2)),
                                       block_num, 1, device=device))
        self.features = nn.Sequential(*feats)
        self.stage_slices = self._compute_stage_slices(len(feats), layers)

        last = base * int(math.pow(2, len(layers) + 1))
        wide = max(1024, base * 16)
        self.conv_last = ConvX(last, wide, 1, 1, device=device)
        self.fc = nn.Linear(wide, wide, bias=False, device=device)
        self.bn = nn.BatchNorm1d(wide, device=device)
        self.linear = nn.Linear(wide, num_classes, bias=False, device=device)
        self.drop = nn.Dropout(p=dropout)

    @staticmethod
    def _compute_stage_slices(n: int, layers) -> List[Tuple[int, int]]:
        """x2 = features[:1], x4 = [1:2], then one bottleneck group per
        ``layers`` entry (JAX stdcnet.py:326-336; the reference hardcodes
        the layers=[2,2,2] boundaries, stdcnet.py:134-138)."""
        l0, l1 = int(layers[0]), int(layers[1])
        if n != 2 + sum(int(v) for v in layers):
            raise ValueError((n, layers))
        return [(0, 1), (1, 2), (2, 2 + l0), (2 + l0, 2 + l0 + l1),
                (2 + l0 + l1, n)]

    def _run_features(self, x: torch.Tensor, keep: Optional[list]):
        for lo, hi in self.stage_slices:
            for idx in range(lo, hi):
                x = self.features[idx](x)
            if keep is not None:
                keep.append(x)
        return x

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Segmentation-mode forward: the five stride-2^k feature maps
        (reference stdcnet.py:185-194)."""
        feats: list = []
        self._run_features(x, feats)
        if self.use_conv_last:
            feats[-1] = self.conv_last(feats[-1])
        return tuple(feats)

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        """ImageNet classifier forward (JAX stdcnet.py:351-374; reference
        stdcnet.py:196-204): conv_last -> pow(2) -> GAP -> fc -> relu ->
        dropout -> linear. ``self.bn`` is defined but, as in the
        reference, never applied."""
        x = self.conv_last(self._run_features(x, None))
        x = x.pow(2).mean(dim=(2, 3))
        x = F.relu(self.fc(x))
        return self.linear(self.drop(x))
