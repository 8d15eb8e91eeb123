"""int8 convolution with the fp32 scale/bias/ReLU epilogue.

No Pallas original: the counterpart of the XLA ops of
``dasemanticsegmentationaml_tpu/ops/quantize.py::int8_conv_epilogue``
(:108), which the JAX package left to XLA and PyTorch has no eager CUDA
form of. On a CUDA tensor the wrapper launches the hand-written Hopper
kernels of ``csrc/int8_conv.cu``: a prologue that quantizes each input
value once into a scratch NHWC int8 tensor (im2col rows for a small Cin),
then an implicit GEMM on ``wgmma`` s8 x s8 -> s32 over a 5-stage
``cp.async`` ring, K split across blocks where the tiles give fewer than
two blocks an SM, and the epilogue staged through shared memory (design,
numerics and bound are noted there; tile and split are ``plan``'s, a pure
function of the shape and the SM count). On a CPU tensor it runs the plain PyTorch version
``int8_conv_reference``: ``quantize_activation``, the convolution of the
int8 values in float64 (products of int8 values summed in float64 are
exact below 2^53; fp32 is not, 127^2 * 9216 > 2^24), cast to int32, then
a separate fp32 multiply and add, ReLU and the cast. The kernels compute
the same operations in the same rounding, and integer sums in any order,
so the two agree bit for bit.

The padding is a ``(pad_h, pad_w)`` pair: a band of rows of the
height-sharded mesh (``ops/quantize.py::QuantBlock``, ``parallel/
spatial.py``) arrives with its halo rows and takes ``pad_h = 0``; an
``int`` means both, as before.

The custom op ``dseg::int8_conv`` is registered here: the kernels'
launcher on CUDA, the plain version on the CPU, and a shape function that
keeps the batch symbolic. Its padding is an ``int[2]``, which an ``int``
fills as both, so an artifact saved when the op took one ``int`` loads
and runs as it did. The wrapper calls the op while ``torch.export``
traces, so that a serving artifact (``utils/export.py``) of an int8 model
carries the kernels; eager calls on a card go to the launcher directly.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import OP_NAMESPACE
from .build import check_launch, current_stream, load_library, sm_count

#: ``int8_conv`` calls that launched the kernels in this process (each
#: launches the prologue ``int8_conv_quantize_kernel`` or
#: ``int8_conv_im2col_kernel``, then ``int8_conv_gemm_kernel``); a run sets
#: it to 0 and reads it afterwards to show the path went through them
LAUNCHES = 0

#: the kernels' geometry (csrc/int8_conv.cu; ``_library`` checks it): output
#: pixels a GEMM tile, bytes of K a stage, bytes a cp.async (the scratch's
#: rows come in 16-byte pieces), the GEMM's tile widths (by Cout), its
#: ring's stages, the im2col prologue's longest row and pixels a block, and
#: the NHWC prologue's tile (pixels, channels)
TILE_M, TILE_K, PIECE = 128, 64, 16
TILE_NS = (32, 64, 128)
STAGES = 5
IM2COL_MAX_K, IM2COL_PIXELS = 144, 256
QUANT_TILE = (128, 32)
#: K is split where the tiles give fewer than this many blocks an SM, into
#: at most ``MAX_SPLITS`` parts of at least ``MIN_SPLIT_STEPS`` stages each
WAVE_BLOCKS, MIN_SPLIT_STEPS, MAX_SPLITS = 2, 4, 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_INT_MAX = 2**31 - 1

#: a conv's padding: one int for rows and columns, or (pad_h, pad_w)
Padding = Union[int, Sequence[int]]


class Plan(NamedTuple):
    """How ``int8_conv`` runs one shape (``plan``)."""
    im2col: bool   # the prologue writes im2col rows (Cin < PIECE), else NHWC
    cq: int        # 16-byte pieces a scratch pixel: channels, or K, / 16
    in_h: int      # the scratch's grid (the output's in im2col mode)
    in_w: int
    ks: int        # the GEMM's conv over the scratch (1, 1, 0 in im2col)
    stride: int
    pad_h: int     # rows of zeros above and below (0 in im2col)
    pad_w: int     # columns left and right
    out_h: int
    out_w: int
    m: int         # output pixels
    kpad: int      # bytes of K a packed weight row, a multiple of TILE_K
    ksteps: int
    tile_n: int
    tiles_m: int
    tiles_n: int
    splits: int    # parts of K, each its own block


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def pad_pair(padding: Padding) -> Tuple[int, int]:
    """``(pad_h, pad_w)`` of an ``int`` (both) or a pair."""
    if isinstance(padding, int):
        return padding, padding
    pad_h, pad_w = (int(p) for p in padding)
    return pad_h, pad_w


def plan(n: int, cin: int, h: int, w: int, cout: int, ks: int, stride: int,
         padding: Padding, sms: int) -> Plan:
    """The kernels' plan for one call, a pure function of the shape and the
    card's SM count: the scratch layout (NHWC with the channels padded to
    a multiple of ``PIECE``, or im2col rows for a small Cin), K padded to
    whole stages, the GEMM's tile width (the smallest of ``TILE_NS`` that
    holds Cout, else the widest) and the split of K: where the tiles give
    fewer than ``WAVE_BLOCKS`` blocks an SM, K is split so that they give
    about that many, into parts of at least ``MIN_SPLIT_STEPS`` stages.
    ``padding``: an ``int`` (rows and columns) or ``(pad_h, pad_w)``."""
    pad_h, pad_w = pad_pair(padding)
    out_h = (h + 2 * pad_h - ks) // stride + 1
    out_w = (w + 2 * pad_w - ks) // stride + 1
    m = n * out_h * out_w
    if cin < PIECE:
        cq = _ceil(ks * ks * cin, PIECE)
        geo = (out_h, out_w, 1, 1, 0, 0)
    else:
        cq = _ceil(cin, PIECE)
        geo = (h, w, ks, stride, pad_h, pad_w)
    taps = geo[2] * geo[2]
    kpad = _ceil(taps * cq * PIECE, TILE_K) * TILE_K
    ksteps = kpad // TILE_K
    tiles_m = _ceil(m, TILE_M)
    tile_n = next((t for t in TILE_NS if cout <= t), TILE_NS[-1])
    tiles_n = _ceil(cout, tile_n)
    tiles = tiles_m * tiles_n
    splits = 1
    if 0 < tiles < WAVE_BLOCKS * sms:
        splits = max(1, min(WAVE_BLOCKS * sms // tiles,
                            ksteps // MIN_SPLIT_STEPS, MAX_SPLITS))
    return Plan(cin < PIECE, cq, *geo, out_h, out_w, m, kpad, ksteps, tile_n,
                tiles_m, tiles_n, splits)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("int8_conv")
    lib.int8_conv_quantize.argtypes = [_P] * 4 + [_I] * 16 + [_P]
    lib.int8_conv_quantize.restype = _I
    lib.int8_conv_gemm.argtypes = [_P] * 7 + [_I] * 20 + [_P]
    lib.int8_conv_gemm.restype = _I
    lib.int8_conv_gemm_blocks_per_sm.argtypes = [_I] * 4
    lib.int8_conv_gemm_blocks_per_sm.restype = _I
    lib.int8_conv_quantize_blocks_per_sm.argtypes = [_I] * 3
    lib.int8_conv_quantize_blocks_per_sm.restype = _I
    got = (lib.int8_conv_tile_m(), lib.int8_conv_tile_k(),
           lib.int8_conv_piece(), lib.int8_conv_stages(),
           lib.int8_conv_im2col_max_k(), lib.int8_conv_im2col_pixels(),
           lib.int8_conv_quantize_pixels(),
           lib.int8_conv_quantize_channels())
    if got != (TILE_M, TILE_K, PIECE, STAGES, IM2COL_MAX_K, IM2COL_PIXELS,
               *QUANT_TILE):
        raise RuntimeError(f"csrc/int8_conv.cu and ops/cuda/int8_conv.py "
                           f"disagree on the geometry: {got}")
    return lib


@functools.lru_cache(maxsize=None)
def _gemm_blocks_per_sm(index: int, out_bf16: bool, ks: int, tile_n: int,
                        slots: int) -> int:
    """Resident GEMM blocks an SM holds with a ring of ``slots`` stages
    (this also sets the instance's shared-memory limit on card ``index``,
    before any launch there)."""
    with torch.cuda.device(index):
        n = _library().int8_conv_gemm_blocks_per_sm(int(out_bf16), ks, tile_n,
                                                    slots)
    if n < 1:
        raise RuntimeError(f"int8_conv: no GEMM block of the instance "
                           f"{(out_bf16, ks, tile_n, slots)} fits an SM")
    return n


@functools.lru_cache(maxsize=None)
def _quantize_blocks_per_sm(index: int, in_bf16: bool, im2col: bool,
                            ks: int) -> int:
    with torch.cuda.device(index):
        n = _library().int8_conv_quantize_blocks_per_sm(int(in_bf16),
                                                        int(im2col), ks)
    if n < 1:
        raise RuntimeError(f"int8_conv: no prologue block of the instance "
                           f"{(in_bf16, im2col, ks)} fits an SM")
    return n


def pack_weights(w_int8: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, k, k) int8 -> the GEMM's (Cout, ``plan(...).kpad``) int8
    rows: K = (kh, kw, channel) with the channels zero-padded to a multiple
    of ``PIECE`` (as the NHWC scratch), or for Cin < ``PIECE`` (kh, kw, ci)
    packed (as the im2col rows); each row zero-padded to whole stages. Made
    once per block, when the model is quantized."""
    cout, cin, kh, kw = w_int8.shape
    rows = w_int8.permute(0, 2, 3, 1)
    if cin >= PIECE:
        rows = F.pad(rows, (0, _ceil(cin, PIECE) * PIECE - cin))
    rows = rows.reshape(cout, -1)
    taps = 1 if cin < PIECE else kh * kw
    k = taps * _ceil(rows.shape[1] // taps, PIECE) * PIECE
    packed = torch.zeros((cout, _ceil(k, TILE_K) * TILE_K), dtype=torch.int8,
                         device=w_int8.device)
    packed[:, :rows.shape[1]] = rows
    return packed


def quantize_activation(x: torch.Tensor,
                        inv_scale: torch.Tensor) -> torch.Tensor:
    """fp tensor -> int8 with a per-tensor scale (JAX quantize.py:102): an
    fp32 multiply by ``inv_scale``, round half to even, clip to +-127; a
    NaN gives 0 (as a float-to-int conversion does, on every device)."""
    xf = x.float() * inv_scale
    q = torch.nan_to_num(torch.round(xf), nan=0.0)
    return torch.clamp(q, -127, 127).to(torch.int8)


def quantize_input_reference(x: torch.Tensor, inv_scale: torch.Tensor,
                             ks: int, stride: int,
                             padding: Padding) -> torch.Tensor:
    """Plain version of the prologue: the scratch that the GEMM of
    ``plan`` reads for a (ks, stride, padding) conv of ``x``, (N, in_h,
    in_w, cq * 16) int8. Each value as the kernel takes it
    (``__fmul_rn``, then ``cvt.rni``: round half to even, NaN to 0,
    saturated, then clamped to +-127); NHWC with the channels zero-padded,
    or in im2col mode (Cin < ``PIECE``) each output pixel's K = (kh, kw,
    ci), the input zero-padded by the conv's padding (``(pad_h, pad_w)``
    or an ``int``), the row zero-padded to whole pieces."""
    n, cin, h, w = x.shape
    pad_h, pad_w = pad_pair(padding)
    p = plan(n, cin, h, w, 1, ks, stride, (pad_h, pad_w), 1)
    v = x.float() * inv_scale
    v = torch.where(torch.isnan(v), torch.zeros_like(v), torch.round(v))
    q = v.clamp(-127, 127).to(torch.int8)
    if not p.im2col:
        rows = q.permute(0, 2, 3, 1)
    else:
        qp = F.pad(q, (pad_w, pad_w, pad_h, pad_h))
        rows = torch.stack([
            qp[:, :, kh:kh + stride * (p.out_h - 1) + 1:stride,
               kw:kw + stride * (p.out_w - 1) + 1:stride]
            for kh in range(ks) for kw in range(ks)], 1)
        rows = rows.permute(0, 3, 4, 1, 2).reshape(n, p.out_h, p.out_w, -1)
    return F.pad(rows, (0, p.cq * PIECE - rows.shape[-1])).contiguous()


def int8_conv_reference(x: torch.Tensor, w_int8: torch.Tensor,
                        out_mul: torch.Tensor, bias: torch.Tensor,
                        in_inv_scale: torch.Tensor, stride: int,
                        padding: Padding, relu: bool = True,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version (JAX quantize.py:108-128 in NCHW/OIHW): the
    int32 sums exactly, by a float64 convolution of the int8 values, then
    ``acc * out_mul + bias`` as two fp32 operations, ReLU, the cast.
    ``padding``: an ``int`` or ``(pad_h, pad_w)``."""
    xq = quantize_activation(x, in_inv_scale)
    acc = F.conv2d(xq.double(), w_int8.double(), stride=stride,
                   padding=pad_pair(padding)).to(torch.int32)
    y = acc.float() * out_mul.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype or x.dtype)


def int8_conv(x: torch.Tensor, w_int8: torch.Tensor, w_packed: torch.Tensor,
              out_mul: torch.Tensor, bias: torch.Tensor,
              in_inv_scale: torch.Tensor, stride: int, padding: Padding,
              relu: bool = True,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(N, Cin, H, W) contiguous fp32/bf16 ``x`` -> (N, Cout, Ho, Wo) of
    ``out_dtype`` (fp32 or bf16; default ``x.dtype``): quantize ``x`` by
    ``in_inv_scale`` (an fp32 scalar tensor), convolve with the int8
    OIHW ``w_int8`` (square kernel 1 or 3, groups 1), then ``acc *
    out_mul + bias`` (fp32, per output channel) and ReLU.
    ``w_packed``: ``pack_weights(w_int8)``. ``padding``: an ``int`` (rows
    and columns) or ``(pad_h, pad_w)``; a band of the height-sharded mesh
    passes its halo rows in ``x`` and ``pad_h = 0``.

    While ``torch.export`` traces, this calls the custom op
    ``dseg::int8_conv``, so that the traced graph (``utils/export.py``)
    holds the kernels as one node; otherwise it calls the op's CUDA
    implementation directly: the dispatcher's path to it costs the host
    about 21 us a call on an H100's host, 35 calls a batch under the
    ``all`` filter (``chip_smoke.py --baseline``, ``time_dispatch``). A
    CUDA tensor always goes through the kernels (the prologue, then the
    GEMM, as ``plan`` says): a failed build, load or launch raises. It
    neither synchronises nor copies from the host, and its scratch (the
    quantized input; split K's partial sums and tile counters) comes from
    ``torch.empty`` in the call, so it may be captured in a CUDA graph
    (once its library and occupancy are cached by an earlier call). A CPU
    tensor goes through the plain version."""
    out_dtype = out_dtype or x.dtype
    _check(x, w_int8, out_dtype)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    args = (x, w_int8, w_packed, out_mul, bias, in_inv_scale, stride,
            list(pad_pair(padding)), relu, out_dtype)
    if x.device.type == "cuda" and not torch.compiler.is_exporting():
        return _int8_conv_launch(*args)
    return _int8_conv_op(*args)


def _check(x: torch.Tensor, w_int8: torch.Tensor,
           out_dtype: torch.dtype) -> None:
    """Raise on what neither version takes (nothing here reads the batch,
    which may be symbolic while a program is exported)."""
    if x.dim() != 4 or w_int8.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W) and w (Cout, Cin, k, k), "
                         f"got {tuple(x.shape)}, {tuple(w_int8.shape)}")
    cin = x.shape[1]
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


#: the op's schema: ``int[2] padding`` takes ``(pad_h, pad_w)``, and an
#: ``int`` fills both (an artifact saved with the one-int schema loads)
_SCHEMA = ("(Tensor x, Tensor w_int8, Tensor w_packed, Tensor out_mul, "
           "Tensor bias, Tensor in_inv_scale, int stride, int[2] padding, "
           "bool relu, ScalarType out_dtype) -> Tensor")


@torch.library.custom_op(f"{OP_NAMESPACE}::int8_conv", mutates_args=(),
                         device_types="cpu", schema=_SCHEMA)
def _int8_conv_op(x: torch.Tensor, w_int8: torch.Tensor,
                  w_packed: torch.Tensor, out_mul: torch.Tensor,
                  bias: torch.Tensor, in_inv_scale: torch.Tensor, stride: int,
                  padding: Sequence[int], relu: bool,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """``dseg::int8_conv`` on the CPU: the plain version."""
    return int8_conv_reference(x, w_int8, out_mul, bias, in_inv_scale,
                               stride, padding, relu, out_dtype)


@_int8_conv_op.register_fake
def _int8_conv_shape(x, w_int8, w_packed, out_mul, bias, in_inv_scale,
                     stride, padding, relu, out_dtype):
    n, _, h, w = x.shape
    cout, _, ks, _ = w_int8.shape
    pad_h, pad_w = pad_pair(padding)
    out_h = (h + 2 * pad_h - ks) // stride + 1
    out_w = (w + 2 * pad_w - ks) // stride + 1
    return x.new_empty((n, cout, out_h, out_w), dtype=out_dtype)


@_int8_conv_op.register_kernel("cuda")
def _int8_conv_launch(x: torch.Tensor, w_int8: torch.Tensor,
                      w_packed: torch.Tensor, out_mul: torch.Tensor,
                      bias: torch.Tensor, in_inv_scale: torch.Tensor,
                      stride: int, padding: Sequence[int], relu: bool,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """``dseg::int8_conv`` on a card: the prologue, then the GEMM. A loaded
    artifact calls the op directly, so the checks run here again, with
    the 32-bit index limit, on the concrete batch."""
    global LAUNCHES
    _check(x, w_int8, out_dtype)
    n, cin, h, w = x.shape
    cout, _, ks, _ = w_int8.shape
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (N, C, H, W)")
    pad_h, pad_w = pad_pair(padding)
    if stride < 1 or min(pad_h, pad_w) < 0 or min(
            (h + 2 * pad_h - ks) // stride, (w + 2 * pad_w - ks) // stride
    ) < 0:
        raise ValueError(f"empty output: {tuple(x.shape)}, stride {stride}, "
                         f"padding {padding}")
    index = x.device.index
    sms = sm_count(index)
    p = plan(n, cin, h, w, cout, ks, stride, (pad_h, pad_w), sms)
    for t, shape, dtype in ((w_packed, (cout, p.kpad), torch.int8),
                            (out_mul, (cout,), torch.float32),
                            (bias, (cout,), torch.float32),
                            (in_inv_scale, (), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"expected a contiguous {dtype} {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    tiles = p.tiles_m * p.tiles_n
    scratch = n * p.in_h * p.in_w * p.cq * PIECE
    if max(x.numel(), p.m * cout, w_packed.numel(), scratch,
           tiles * p.splits * TILE_M * p.tile_n) > _INT_MAX:
        raise ValueError("the shape exceeds the kernel's 32-bit indices")
    out = torch.empty((n, cout, p.out_h, p.out_w), dtype=out_dtype,
                      device=x.device)
    if n == 0:
        return out
    xq = torch.empty((n, p.in_h, p.in_w, p.cq * PIECE), dtype=torch.int8,
                     device=x.device)
    partial = counters = None
    if p.splits > 1:
        partial = torch.empty(tiles * p.splits * TILE_M * p.tile_n,
                              dtype=torch.int32, device=x.device)
        counters = torch.empty(tiles, dtype=torch.int32, device=x.device)
    in_bf16, out_bf16 = x.dtype == torch.bfloat16, out_dtype == torch.bfloat16
    if p.im2col:
        q_tiles = _ceil(p.m, IM2COL_PIXELS)
    else:
        q_tiles = n * _ceil(h * w, QUANT_TILE[0]) * _ceil(p.cq * PIECE,
                                                        QUANT_TILE[1])
    q_grid = min(q_tiles, sms * _quantize_blocks_per_sm(index, in_bf16,
                                                         p.im2col, ks))
    g_grid = min(tiles * p.splits,
                 sms * _gemm_blocks_per_sm(index, out_bf16, p.ks, p.tile_n,
                                           min(STAGES, p.ksteps)))
    vec_in = (h * w) % 4 == 0 and x.data_ptr() % 16 == 0
    vec_out = (p.out_h * p.out_w) % (16 // out.element_size()) == 0
    stream = current_stream(x.device)
    lib = _library()
    check_launch(lib.int8_conv_quantize(
        x.data_ptr(), xq.data_ptr(), in_inv_scale.data_ptr(),
        counters.data_ptr() if counters is not None else None,
        tiles if counters is not None else 0, int(in_bf16), int(p.im2col),
        int(vec_in), n, cin, h, w, p.cq, ks, stride, pad_h, pad_w, p.out_h,
        p.out_w, q_grid, stream), "int8_conv (quantize)")
    check_launch(lib.int8_conv_gemm(
        xq.data_ptr(), w_packed.data_ptr(), out_mul.data_ptr(),
        bias.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        counters.data_ptr() if counters is not None else None,
        int(out_bf16), p.ks, p.tile_n, p.in_h, p.in_w, p.cq, p.stride,
        p.pad_h, p.pad_w, p.out_h, p.out_w, cout, p.m, p.kpad, int(relu),
        p.tiles_m, p.tiles_n, p.splits, int(vec_out), g_grid, stream),
        "int8_conv (gemm)")
    LAUNCHES += 1
    return out
