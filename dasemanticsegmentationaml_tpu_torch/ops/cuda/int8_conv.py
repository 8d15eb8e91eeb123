"""int8 convolution with the fp32 scale/bias/ReLU epilogue.

No Pallas original: the counterpart of the XLA ops of
``dasemanticsegmentationaml_tpu/ops/quantize.py::int8_conv_epilogue``
(:108), which the JAX package left to XLA and PyTorch has no eager CUDA
form of. On a CUDA tensor the wrapper launches the hand-written Hopper
kernel ``csrc/int8_conv.cu`` (an implicit GEMM on ``mma.sync`` s8 x s8 ->
s32 that quantizes the activations as it loads them; design, numerics and
bound are noted there); on a CPU tensor it runs the plain PyTorch version
``int8_conv_reference``: ``quantize_activation``, the convolution of the
int8 values in float64 (products of int8 values summed in float64 are
exact below 2^53; fp32 is not, 127^2 * 9216 > 2^24), cast to int32, then
a separate fp32 multiply and add, ReLU and the cast. The kernel computes
the same operations in the same rounding, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from .build import check_launch, current_stream, load_library, sm_count

#: kernel launches made by ``int8_conv`` in this process; a run sets it to
#: 0 and reads it afterwards to show the path went through the kernel
LAUNCHES = 0

#: the kernel's tile: output pixels, output channels, K a stage
#: (csrc/int8_conv.cu::kBM / kBN / kBK; ``_library`` checks they agree)
TILE_M, TILE_N, TILE_K = 128, 64, 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("int8_conv")
    lib.int8_conv.argtypes = [_P] * 6 + [_I] * 19 + [_P]
    lib.int8_conv.restype = _I
    lib.int8_conv_blocks_per_sm.argtypes = [_I] * 4
    lib.int8_conv_blocks_per_sm.restype = _I
    if (lib.int8_conv_tile_m(), lib.int8_conv_tile_n(),
            lib.int8_conv_tile_k()) != (TILE_M, TILE_N, TILE_K):
        raise RuntimeError("csrc/int8_conv.cu and ops/cuda/int8_conv.py "
                           "disagree on the tile")
    return lib


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, in_bf16: bool, out_bf16: bool, ks: int,
                   tap_major: bool) -> int:
    with torch.cuda.device(index):
        n = _library().int8_conv_blocks_per_sm(int(in_bf16), int(out_bf16),
                                               ks, int(tap_major))
    if n < 1:
        raise RuntimeError(f"int8_conv: no block of the instance "
                           f"{(in_bf16, out_bf16, ks, tap_major)} fits an SM")
    return n


def tap_major(c_in: int) -> bool:
    """K runs (kh, kw, ci) when a stage of ``TILE_K`` is one tap, else in
    PyTorch's (ci, kh, kw) order (csrc/int8_conv.cu)."""
    return c_in % TILE_K == 0


def pack_weights(w_int8: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, k, k) int8 -> the kernel's (Cout rounded up to
    ``TILE_N``, K rounded up to ``TILE_K``) int8 rows, K in the kernel's
    order, zero-padded. Made once per block, when the model is quantized."""
    cout, cin, kh, kw = w_int8.shape
    rows = (w_int8.permute(0, 2, 3, 1) if tap_major(cin) else w_int8)
    rows = rows.reshape(cout, cin * kh * kw)
    k = rows.shape[1]
    rows_pad = -(-cout // TILE_N) * TILE_N
    packed = torch.zeros((rows_pad, -(-k // TILE_K) * TILE_K),
                         dtype=torch.int8, device=w_int8.device)
    packed[:cout, :k] = rows
    return packed


def quantize_activation(x: torch.Tensor,
                        inv_scale: torch.Tensor) -> torch.Tensor:
    """fp tensor -> int8 with a per-tensor scale (JAX quantize.py:102): an
    fp32 multiply by ``inv_scale``, round half to even, clip to +-127."""
    xf = x.float() * inv_scale
    return torch.clamp(torch.round(xf), -127, 127).to(torch.int8)


def int8_conv_reference(x: torch.Tensor, w_int8: torch.Tensor,
                        out_mul: torch.Tensor, bias: torch.Tensor,
                        in_inv_scale: torch.Tensor, stride: int, padding: int,
                        relu: bool = True,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version (JAX quantize.py:108-128 in NCHW/OIHW): the
    int32 sums exactly, by a float64 convolution of the int8 values, then
    ``acc * out_mul + bias`` as two fp32 operations, ReLU, the cast."""
    xq = quantize_activation(x, in_inv_scale)
    acc = F.conv2d(xq.double(), w_int8.double(), stride=stride,
                   padding=padding).to(torch.int32)
    y = acc.float() * out_mul.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype or x.dtype)


def int8_conv(x: torch.Tensor, w_int8: torch.Tensor, w_packed: torch.Tensor,
              out_mul: torch.Tensor, bias: torch.Tensor,
              in_inv_scale: torch.Tensor, stride: int, padding: int,
              relu: bool = True,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(N, Cin, H, W) contiguous fp32/bf16 ``x`` -> (N, Cout, Ho, Wo) of
    ``out_dtype`` (fp32 or bf16; default ``x.dtype``): quantize ``x`` by
    ``in_inv_scale`` (an fp32 scalar tensor), convolve with the int8
    OIHW ``w_int8`` (square kernel 1 or 3, groups 1), then ``acc *
    out_mul + bias`` (fp32, per output channel) and ReLU.
    ``w_packed``: ``pack_weights(w_int8)``.

    A CUDA tensor always goes through the kernel: a failed build, load or
    launch raises. It neither synchronises nor copies from the host, so
    it may be captured in a CUDA graph (once its library and occupancy
    are cached by an earlier call). A CPU tensor goes through the plain
    version."""
    global LAUNCHES
    out_dtype = out_dtype or x.dtype
    if x.dim() != 4 or w_int8.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W) and w (Cout, Cin, k, k), "
                         f"got {tuple(x.shape)}, {tuple(w_int8.shape)}")
    n, cin, h, w = x.shape
    cout, wcin, ks, ks2 = w_int8.shape
    if wcin != cin or ks != ks2 or ks not in (1, 3):
        raise ValueError(f"weights {tuple(w_int8.shape)} do not take input "
                         f"{tuple(x.shape)} (square kernel 1 or 3, groups 1)")
    if x.dtype not in (torch.float32, torch.bfloat16) or out_dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"x and the output must be float32 or bfloat16, got "
                        f"{x.dtype} -> {out_dtype}")
    if w_int8.dtype != torch.int8:
        raise TypeError(f"weights must be int8, got {w_int8.dtype}")
    if x.device.type == "cpu":
        return int8_conv_reference(x, w_int8, out_mul, bias, in_inv_scale,
                                   stride, padding, relu, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (N, C, H, W)")
    k = cin * ks * ks
    kp = -(-k // TILE_K) * TILE_K
    tiles_n = -(-cout // TILE_N)
    for t, shape, dtype in ((w_packed, (tiles_n * TILE_N, kp), torch.int8),
                            (out_mul, (cout,), torch.float32),
                            (bias, (cout,), torch.float32),
                            (in_inv_scale, (), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"expected a contiguous {dtype} {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    out_h = (h + 2 * padding - ks) // stride + 1
    out_w = (w + 2 * padding - ks) // stride + 1
    if min(out_h, out_w) < 1 or stride < 1 or padding < 0:
        raise ValueError(f"empty output: {tuple(x.shape)}, stride {stride}, "
                         f"padding {padding}")
    if max(x.numel(), n * cout * out_h * out_w, w_packed.numel()) > _INT_MAX:
        raise ValueError("the shape exceeds the kernel's 32-bit indices")
    out = torch.empty((n, cout, out_h, out_w), dtype=out_dtype,
                      device=x.device)
    if n == 0:
        return out
    tm = tap_major(cin)
    in_bf16, out_bf16 = x.dtype == torch.bfloat16, out_dtype == torch.bfloat16
    tiles_m = -(-(n * out_h * out_w) // TILE_M)
    index = x.device.index
    grid = min(tiles_m * tiles_n,
               sm_count(index) * _blocks_per_sm(index, in_bf16, out_bf16, ks,
                                                tm))
    check_launch(_library().int8_conv(
        x.data_ptr(), w_packed.data_ptr(), out_mul.data_ptr(),
        bias.data_ptr(), in_inv_scale.data_ptr(), out.data_ptr(),
        int(in_bf16), int(out_bf16), ks, int(tm), n, cin, h, w, cout, out_h,
        out_w, stride, padding, k, kp, int(relu), tiles_m, tiles_n, grid,
        current_stream(x.device)), "int8_conv")
    LAUNCHES += 1
    return out
