"""BiSeNet-STDC813 as ``nn.Module``s (NCHW)."""

from .bisenet import BiSeNet, build_bisenet
from .stdcnet import STDCNet813

__all__ = ["BiSeNet", "STDCNet813", "build_bisenet"]
