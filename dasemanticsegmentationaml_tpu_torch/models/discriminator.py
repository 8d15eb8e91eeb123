"""Output-space domain discriminators (AdaptSegNet style), PyTorch, NCHW.

Counterpart of ``dasemanticsegmentationaml_tpu/models/discriminator.py``,
after reference model/discriminator.py:

* ``FCDiscriminator``               -- 5 x (4x4 stride-2 conv + LeakyReLU
                                       0.2), 2,781,121 parameters (JAX :51;
                                       reference :4-28)
* ``DepthWiseSepFCDiscriminator``   -- depthwise 4x4 s2 + pointwise 1x1
                                       pairs, 190,340 parameters (JAX :75;
                                       reference :30-73). The pointwise
                                       convs keep the reference's
                                       ``padding=1`` (:36,39,42,45), which
                                       grows each map by 2 pixels a side
                                       and the output by one (JAX :7-12).
* ``DepthWiseSepBNFCDiscriminator`` -- the same with BatchNorm after every
                                       conv but the classifier, 193,194
                                       parameters (JAX :105; reference
                                       :75-134)

Inputs are softmax maps (B, num_classes, H, W). Every conv has a bias, as
torch's ``Conv2d`` default; attribute names give the reference's
state-dict keys (``conv1_d``, ``bn1_p``, ``classifier``, ...). BN is
``nn.BatchNorm2d(eps=1e-5, momentum=0.1)`` (JAX ops/norm.py:35-101).

Each forward is the chain of ``layers()``: (conv, BN or None, LeakyReLU
or not) in order, which the height-sharded mesh walks on a band
(``parallel/spatial.py::SpatialMesh.discriminator``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class _Chain(nn.Module):
    """A discriminator whose forward is its ``layers()`` in order."""

    def layers(self):
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm, act in self.layers():
            x = conv(x)
            if norm is not None:
                x = norm(x)
            if act:
                x = _lrelu(x)
        return x


class FCDiscriminator(_Chain):
    """Reference discriminator.py:4-28 (JAX :51)."""

    def __init__(self, num_classes: int, ndf: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(num_classes, ndf, 4, 2, 1)
        self.conv2 = nn.Conv2d(ndf, ndf * 2, 4, 2, 1)
        self.conv3 = nn.Conv2d(ndf * 2, ndf * 4, 4, 2, 1)
        self.conv4 = nn.Conv2d(ndf * 4, ndf * 8, 4, 2, 1)
        self.classifier = nn.Conv2d(ndf * 8, 1, 4, 2, 1)

    def layers(self):
        return [(conv, None, True) for conv in
                (self.conv1, self.conv2, self.conv3, self.conv4)] \
            + [(self.classifier, None, False)]


class DepthWiseSepFCDiscriminator(_Chain):
    """Reference discriminator.py:30-73 (JAX :75), padding=1 pointwise
    convs kept."""

    def __init__(self, num_classes: int, ndf: int = 64):
        super().__init__()
        chans = (num_classes, ndf, ndf * 2, ndf * 4, ndf * 8)
        for i in range(4):
            c_in, c_out = chans[i], chans[i + 1]
            setattr(self, f"conv{i + 1}_d",
                    nn.Conv2d(c_in, c_in, 4, 2, 1, groups=c_in))
            setattr(self, f"conv{i + 1}_p", nn.Conv2d(c_in, c_out, 1, 1, 1))
        self.classifier = nn.Conv2d(ndf * 8, 1, 4, 2, 1)

    def layers(self):
        return [(getattr(self, f"conv{i}_{s}"), None, True)
                for i in range(1, 5) for s in "dp"] \
            + [(self.classifier, None, False)]


class DepthWiseSepBNFCDiscriminator(_Chain):
    """Reference discriminator.py:75-134 (JAX :105): BN after every conv
    of the depthwise-separable pairs."""

    def __init__(self, num_classes: int, ndf: int = 64):
        super().__init__()
        chans = (num_classes, ndf, ndf * 2, ndf * 4, ndf * 8)
        for i in range(4):
            c_in, c_out = chans[i], chans[i + 1]
            setattr(self, f"conv{i + 1}_d",
                    nn.Conv2d(c_in, c_in, 4, 2, 1, groups=c_in))
            setattr(self, f"bn{i + 1}_d", _bn(c_in))
            setattr(self, f"conv{i + 1}_p", nn.Conv2d(c_in, c_out, 1, 1, 1))
            setattr(self, f"bn{i + 1}_p", _bn(c_out))
        self.classifier = nn.Conv2d(ndf * 8, 1, 4, 2, 1)

    def layers(self):
        return [(getattr(self, f"conv{i}_{s}"), getattr(self, f"bn{i}_{s}"),
                 True) for i in range(1, 5) for s in "dp"] \
            + [(self.classifier, None, False)]


def build_discriminator(num_classes: int, depthwise: bool = False,
                        batch_norm: bool = False, device=None,
                        generator: torch.Generator = None) -> nn.Module:
    """The reference's choice (train.py:144-152; JAX :148): FC unless
    ``depthwise``; then with BN iff ``batch_norm``. ``generator`` seeds the
    initial weights (torch's default init, drawn on the CPU), as
    ``models/bisenet.py::build_bisenet`` does."""
    if not depthwise:
        cls = FCDiscriminator
    elif batch_norm:
        cls = DepthWiseSepBNFCDiscriminator
    else:
        cls = DepthWiseSepFCDiscriminator
    model = cls(num_classes)
    if generator is not None:
        _reseed(model, generator)
    return model.to(device) if device is not None else model


@torch.no_grad()
def _reseed(model: nn.Module, generator: torch.Generator) -> None:
    """torch's default Conv2d init (kaiming-uniform, a=sqrt(5), and a
    uniform bias in +-1/sqrt(fan_in)), drawn from ``generator``."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            bound = 1.0 / fan_in ** 0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
