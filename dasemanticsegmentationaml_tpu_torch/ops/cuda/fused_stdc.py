"""A whole inference-mode STDC CatBottleneck in one kernel launch.

Counterpart of the Pallas TPU kernels ``dasemanticsegmentationaml_tpu/ops/
pallas/fused_stdc.py::fused_cat_bottleneck`` (:424; ``fused_cat_s1`` :326,
``fused_cat_s2`` :376) with their folding (``FoldedCat`` / ``fold_cat_params``
:74-114). One CatBottleneck (reference stdcnet.py:66-113) with its BN folded
into the convolutions: the 1x1 entry conv, at stride 2 the depthwise 3x3 s2
``avd`` conv + BN and the 3x3 s2 average-pool skip, three chained 3x3
ConvX, and the channel concat ``[x1 or pool, x2, x3, x4]``.

On a CUDA tensor ``fused_cat_bottleneck`` launches the hand-written Hopper
kernel of ``csrc/fused_stdc.cu`` (design, bound and tiling are noted
there); a failed build, load or launch raises. On a CPU tensor it runs the
plain PyTorch version ``fused_cat_bottleneck_plain``. Both compute what
the TPU kernel computes: operands in the input dtype, fp32 sums, fp32
bias and ReLU, and every intermediate rounded to the input dtype
(fused_stdc.py:29-31, ``_mask`` :119-131), zero outside the image.

The public layout is the port's NCHW, as ``models/stdcnet.py::
CatBottleneck.forward``, so a call can stand in for the module in eval
mode. Like the JAX package (fused_stdc.py:37), no path of the port calls
it by default: ``fold_cat_params`` then ``fused_cat_bottleneck`` is its
path.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...models.stdcnet import CatBottleneck
from ..norm import fold_bn_into_conv
from .build import check_launch, current_stream, load_library

#: launches of the stride-1 and stride-2 kernels made by
#: ``fused_cat_bottleneck`` in this process; a run sets them to 0 and reads
#: them afterwards to show that its path went through the kernels
S1_LAUNCHES = 0
S2_LAUNCHES = 0

#: dynamic shared memory one block may take on an H100 (227 KB)
SMEM_LIMIT = 232_448
#: SMs of an H100; the tile choice penalises grids smaller than this
_SMS = 132
_INT_MAX = 2**31 - 1
_SIZES = (1, 2, 4, 8, 16, 32)
#: candidate (rows, cols) output tiles of one block
_TILES = tuple((th, tw) for th in _SIZES for tw in _SIZES
               if th * tw <= 512 and th <= 2 * tw and tw <= 8 * th)
#: x1 channels a stride-2 block computes at a time (the wrapper pads the
#: entry conv's output channels to a multiple of the largest)
_CHUNKS = (32, 16, 8)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 12 + [_I] * 15 + [_P]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("fused_stdc")
    for fn in (lib.fused_cat_s1_f32, lib.fused_cat_s1_bf16,
               lib.fused_cat_s2_f32, lib.fused_cat_s2_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_cols(w: torch.Tensor, cols: int) -> torch.Tensor:
    """(K, n) fp32 -> a fresh contiguous (K, cols) with zero columns."""
    out = torch.zeros((w.shape[0], cols), dtype=torch.float32, device=w.device)
    out[:, :w.shape[1]] = w
    return out


def _pad_vec(b: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=torch.float32, device=b.device)
    out[:b.shape[0]] = b
    return out


@dataclass(frozen=True)
class FoldedCat:
    """BN-folded CatBottleneck weights (JAX fused_stdc.py:74-87), OIHW.

    Weights are in the kernel dtype, biases fp32. ``packed`` holds the same
    values as the kernel reads them: fp32 (exact copies), each conv as a
    (Cin * kh * kw, Cout_padded) matrix with the output channel fastest,
    the entry conv padded to a multiple of 32 output channels and the
    others to a multiple of 8."""

    w1: torch.Tensor                 # (h1, Cin, 1, 1)
    b1: torch.Tensor                 # (h1,)
    k2: torch.Tensor                 # (h2, h1, 3, 3)
    b2: torch.Tensor
    k3: torch.Tensor                 # (h3, h2, 3, 3)
    b3: torch.Tensor
    k4: torch.Tensor                 # (h4, h3, 3, 3)
    b4: torch.Tensor
    avd_k: Optional[torch.Tensor] = None   # (h1, 1, 3, 3), stride 2 only
    avd_b: Optional[torch.Tensor] = None   # (h1,)
    stride: int = 1
    packed: Tuple[torch.Tensor, ...] = field(default=(), init=False,
                                             repr=False, compare=False)

    def __post_init__(self):
        h1, cin = self.w1.shape[:2]
        with torch.no_grad():
            packed = [_pad_cols(self.w1.float().reshape(h1, cin).t(),
                                _round_up(h1, 32)),
                      _pad_vec(self.b1.float(), _round_up(h1, 32))]
            for k, b in ((self.k2, self.b2), (self.k3, self.b3),
                         (self.k4, self.b4)):
                cout, c_in = k.shape[:2]
                packed += [_pad_cols(k.float().permute(1, 2, 3, 0)
                                     .reshape(c_in * 9, cout),
                                     _round_up(cout, 8)),
                           _pad_vec(b.float(), _round_up(cout, 8))]
            if self.stride == 2:
                packed += [self.avd_k.float().reshape(h1, 9).contiguous(),
                           self.avd_b.float().contiguous()]
        object.__setattr__(self, "packed", tuple(packed))

    @property
    def channels(self) -> Tuple[int, int, int, int]:
        """(h1, h2, h3, h4): the four parts of the concat."""
        return (self.w1.shape[0], self.k2.shape[0], self.k3.shape[0],
                self.k4.shape[0])

    @property
    def in_channels(self) -> int:
        return self.w1.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.w1.dtype


def _fold_convx(m, dtype):
    """ConvX -> (OIHW weight in ``dtype``, fp32 bias) (JAX :90-95)."""
    w, b = fold_bn_into_conv(
        m.conv.weight.detach().float(), None, m.bn.weight.detach().float(),
        m.bn.bias.detach().float(), m.bn.running_mean.float(),
        m.bn.running_var.float(), m.bn.eps)
    return w.to(dtype), b.float()


def fold_cat_params(block: CatBottleneck,
                    dtype: torch.dtype = torch.bfloat16) -> FoldedCat:
    """Fold one CatBottleneck's four ConvX (and, at stride 2, its ``avd``
    conv + BN) with their running statistics (JAX fused_stdc.py:98-114).
    The block must have ``block_num`` 4, as every STDC813 bottleneck has."""
    if len(block.conv_list) != 4:
        raise ValueError(f"the kernel takes block_num 4, got "
                         f"{len(block.conv_list)}")
    (w1, b1), (k2, b2), (k3, b3), (k4, b4) = (
        _fold_convx(m, dtype) for m in block.conv_list)
    avd_k = avd_b = None
    if block.stride == 2:
        conv, bn = block.avd_layer
        avd_k, avd_b = fold_bn_into_conv(
            conv.weight.detach().float(), None, bn.weight.detach().float(),
            bn.bias.detach().float(), bn.running_mean.float(),
            bn.running_var.float(), bn.eps)
        avd_k, avd_b = avd_k.to(dtype), avd_b.float()
    return FoldedCat(w1=w1, b1=b1, k2=k2, b2=b2, k3=k3, b3=b3, k4=k4, b4=b4,
                     avd_k=avd_k, avd_b=avd_b, stride=block.stride)


def fused_cat_bottleneck_plain(x: torch.Tensor, fp: FoldedCat) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv2d`` / ``F.avg_pool2d`` on the folded
    weights in fp32, each intermediate rounded to ``x.dtype``."""
    dt = x.dtype

    def convx(src, k, b, relu=True, **kw):
        y = F.conv2d(src.float(), k.float(), **kw) + b.view(1, -1, 1, 1)
        return (F.relu(y) if relu else y).to(dt)

    x1 = convx(x, fp.w1, fp.b1)
    if fp.stride == 2:
        head = F.avg_pool2d(x1.float(), 3, 2, 1,
                            count_include_pad=True).to(dt)
        src = convx(x1, fp.avd_k, fp.avd_b, relu=False, stride=2, padding=1,
                    groups=x1.shape[1])
    else:
        head = src = x1
    x2 = convx(src, fp.k2, fp.b2, padding=1)
    x3 = convx(x2, fp.k3, fp.b3, padding=1)
    x4 = convx(x3, fp.k4, fp.b4, padding=1)
    return torch.cat([head, x2, x3, x4], dim=1)


def supported(shape: Tuple[int, ...], stride: int) -> bool:
    """The NCHW input shapes the kernels take at ``stride``: any non-empty
    image whose planes fit the kernel's int offsets. This includes every
    shape the TPU kernels take (JAX fused_stdc.py:431-437: even sizes and
    an 8-divisible row count), and odd sizes at either stride."""
    if stride not in (1, 2) or len(shape) != 4 or min(shape) < 1:
        return False
    _, c, h, w = shape
    return c * h * w <= _INT_MAX


@dataclass(frozen=True)
class Plan:
    """One block's output tile, x1 chunk (stride 2) and shared memory:
    ``off_b`` is the byte offset of the second buffer, ``smem`` the total."""
    th: int
    tw: int
    chunk: int
    off_b: int
    smem: int


def plan(stride: int, elem: int, c_in: int, channels: Tuple[int, ...],
         batch: int, out_hw: Tuple[int, int]) -> Optional[Plan]:
    """The tile that fits ``SMEM_LIMIT`` with the least work, counting the
    recomputed halo, or None. ``elem``: bytes of the activation dtype.

    Stride 1: buffer A holds x1 over the tile + 3 pixels of halo, B holds
    x2 over the tile + 2; x3 (tile + 1) goes back into A. Stride 2: A holds
    the avd output over the tile + 3 (half resolution), B first one chunk
    of x1 at full resolution (2 (t + 6) + 1 per side), then x2; x3 goes
    back into A."""
    h1, h2, h3, h4 = channels
    out_h, out_w = out_hw
    best, best_key = None, None
    for th, tw in _TILES:
        r1 = (th + 6) * (tw + 6)
        r2 = (th + 4) * (tw + 4)
        r3 = (th + 2) * (tw + 2)
        chain = 9 * (r2 * h1 * h2 + r3 * h2 * h3 + th * tw * h3 * h4)
        for chunk in (_CHUNKS if stride == 2 else (0,)):
            a = h1 * r1 * elem
            full = (2 * th + 13) * (2 * tw + 13)
            b = (max(chunk * full, h2 * r2) if stride == 2 else h2 * r2) * elem
            off_b = _round_up(a, 16)
            smem = off_b + b
            if smem > SMEM_LIMIT:
                continue
            tiles = batch * -(-out_h // th) * -(-out_w // tw)
            macs = chain + (full * c_in * h1 + 9 * r1 * h1 if stride == 2
                            else r1 * c_in * h1)
            cost = tiles * macs * max(1.0, _SMS / tiles)
            key = (cost, -th * tw, -chunk)
            if best_key is None or key < best_key:
                best, best_key = Plan(th, tw, chunk, off_b, smem), key
    return best


def fused_cat_bottleneck(x: torch.Tensor, fp: FoldedCat) -> torch.Tensor:
    """(B, Cin, H, W) -> (B, h1+h2+h3+h4, ceil(H/s), ceil(W/s)), the
    CatBottleneck of ``fp`` in eval mode, in ``x``'s dtype.

    x: contiguous fp32 or bf16, of ``fp``'s dtype. A CUDA tensor always
    goes through the kernel (stride 1 or 2); a CPU tensor through the
    plain version."""
    global S1_LAUNCHES, S2_LAUNCHES
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dtype != fp.dtype:
        raise TypeError(f"x is {x.dtype} but the folded weights are "
                        f"{fp.dtype}")
    if x.shape[1] != fp.in_channels:
        raise ValueError(f"x has {x.shape[1]} channels, the block takes "
                         f"{fp.in_channels}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (B, C, H, W)")
    if not supported(tuple(x.shape), fp.stride):
        raise ValueError(f"unsupported shape {tuple(x.shape)} at stride "
                         f"{fp.stride}")
    if x.device.type == "cpu":
        return fused_cat_bottleneck_plain(x, fp)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if any(t.device != x.device for t in fp.packed):
        raise ValueError(f"the folded weights are not on {x.device}")
    b, c_in, h, w = x.shape
    s = fp.stride
    out_hw = (-(-h // s), -(-w // s))
    channels = fp.channels
    out_c = sum(channels)
    if out_c * out_hw[0] * out_hw[1] > _INT_MAX:
        raise ValueError("the output plane exceeds the kernel's int range")
    p = plan(s, x.element_size(), c_in, channels, b, out_hw)
    if p is None:
        raise ValueError(f"no tile of channels {channels} fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    out = torch.empty((b, out_c, *out_hw), dtype=x.dtype, device=x.device)
    lib = _library()
    name = f"fused_cat_s{s}_{'f32' if x.dtype == torch.float32 else 'bf16'}"
    ptrs = [t.data_ptr() for t in fp.packed] + [None] * (10 - len(fp.packed))
    check_launch(getattr(lib, name)(
        x.data_ptr(), out.data_ptr(), *ptrs, b, c_in, h, w, *channels,
        *out_hw, p.th, p.tw, p.chunk, p.off_b, p.smem,
        current_stream(x.device)), name)
    if s == 2:
        S2_LAUNCHES += 1
    else:
        S1_LAUNCHES += 1
    return out

