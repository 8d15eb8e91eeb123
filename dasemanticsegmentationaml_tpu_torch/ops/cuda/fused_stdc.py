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
there): in bf16 the tensor-core body, planned by ``tc_plan`` and fed the
MMA packing of ``pack_mma``; in fp32 the CUDA-core body, planned by
``plan``. A failed build, load or launch raises. On a CPU tensor it runs the
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
from .build import check_launch, current_stream, load_library, sm_count

#: launches of the stride-1 and stride-2 kernels made by
#: ``fused_cat_bottleneck`` in this process; a run sets them to 0 and reads
#: them afterwards to show that its path went through the kernels
S1_LAUNCHES = 0
S2_LAUNCHES = 0

#: dynamic shared memory one block may take on an H100 (227 KB)
SMEM_LIMIT = 232_448
#: shared memory of one SM (228 KB), of which each resident block also
#: takes 1 KB for the system
SMEM_PER_SM = 233_472
_INT_MAX = 2**31 - 1
_SIZES = (1, 2, 4, 8, 16, 32)
#: candidate (rows, cols) output tiles of one block
_TILES = tuple((th, tw) for th in _SIZES for tw in _SIZES
               if th * tw <= 512 and th <= 2 * tw and tw <= 8 * th)
#: x1 channels a stride-2 block computes at a time (the wrapper pads the
#: entry conv's output channels to a multiple of the largest)
_CHUNKS = (32, 16, 8)

#: the bf16 body (``csrc/fused_stdc.cu``, namespace ``tc``): output
#: channels of one item (the MMA's N a block), slots of the weight ring,
#: bytes of one slot (the largest slice: 64 x (64 + 8) bf16), bytes before
#: the ring (its mbarriers) and the most blocks an SM takes
#: (``__launch_bounds__``)
TC_BN = 64
TC_SLOTS = 3
TC_SLOT_BYTES = TC_BN * (64 + 8) * 2
TC_BAR_BYTES = 128
TC_MAX_BLOCKS_PER_SM = 3

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 12 + [_I] * 15 + [_P]


class _Stage(ctypes.Structure):
    """``tc::Stage`` of ``csrc/fused_stdc.cu``, field for field."""
    _fields_ = [("w", _P), ("bias", _P), ("src", _P), ("mid", _P)] + [
        (n, _I) for n in ("src_c", "mid_c", "src_h", "src_w", "cin", "cout",
                          "out_off", "kc", "nk", "taps", "nblk", "mt", "th",
                          "tw", "tiles_y", "tiles_x", "items",
                          "buf_bytes")]


class _Params(ctypes.Structure):
    """``tc::Params`` of ``csrc/fused_stdc.cu``, field for field."""
    _fields_ = [("st", _Stage * 4), ("out", _P), ("avd_w", _P),
                ("avd_b", _P), ("bar", _P)] + [
        (n, _I) for n in ("B", "ctot", "Ho", "Wo", "off_act", "dw_th",
                          "dw_tw", "dw_tiles_y", "dw_tiles_x", "dw_items")]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("fused_stdc")
    for fn in (lib.fused_cat_s1_f32, lib.fused_cat_s2_f32):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.fused_cat_bf16.argtypes = [_P, _I, _I, _I, _P]
    lib.fused_cat_bf16.restype = ctypes.c_int
    lib.fused_cat_bf16_blocks_per_sm.argtypes = [_I, _I]
    lib.fused_cat_bf16_blocks_per_sm.restype = ctypes.c_int
    lib.fused_cat_bf16_params_size.restype = ctypes.c_int
    size = lib.fused_cat_bf16_params_size()
    if size != ctypes.sizeof(_Params):
        raise RuntimeError(f"tc::Params is {size} bytes, the wrapper's "
                           f"{ctypes.sizeof(_Params)}")
    return lib


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device_index: int, stride: int, smem: int) -> int:
    """Blocks of the bf16 kernel one SM of the card holds at ``smem``."""
    with torch.cuda.device(device_index):
        n = _library().fused_cat_bf16_blocks_per_sm(stride, smem)
    if n < 1:
        raise RuntimeError(f"the bf16 kernel does not fit an SM at {smem} "
                           f"bytes of shared memory")
    return n


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


def mma_chunk(cin: int) -> int:
    """Input channels of one K-slice of the bf16 body: 64, or the input
    channels rounded up to the MMA's k of 16."""
    return min(64, _round_up(cin, 16))


def pack_mma(k: torch.Tensor) -> torch.Tensor:
    """OIHW bf16 weights -> the bf16 body's slices, (nblk, nk, taps, 64,
    kc + 8): slice [nb, c, t] holds output channels nb * 64 .. + 63 (rows)
    times input channels c * kc .. + kc - 1 of tap t (kh * 3 + kw), each
    row padded with 8 zeros, so that it is the shared-memory image the MMA
    reads (a 16-byte row pitch of kc + 8, odd in 16-byte units, so
    ldmatrix's 8 rows meet no bank conflict); output and input channels
    past the conv's are zero."""
    cout, cin, kh, kw = k.shape
    kc = mma_chunk(cin)
    nblk, nk, taps = -(-cout // TC_BN), -(-cin // kc), kh * kw
    w = torch.zeros((nblk * TC_BN, nk * kc, taps), dtype=k.dtype,
                    device=k.device)
    w[:cout, :cin] = k.reshape(cout, cin, taps)
    w = w.reshape(nblk, TC_BN, nk, kc, taps).permute(0, 2, 4, 1, 3)
    return F.pad(w, (0, 8)).contiguous()


@dataclass(frozen=True)
class FoldedCat:
    """BN-folded CatBottleneck weights (JAX fused_stdc.py:74-87), OIHW.

    Weights are in the kernel dtype, biases fp32. ``packed`` holds the same
    values as the kernel reads them, (w1, b1, k2, b2, k3, b3, k4, b4) and at
    stride 2 (avd, avd_b): in bf16 each conv by ``pack_mma`` and each bias
    padded to a multiple of 64; in fp32 (exact copies) each conv as a
    (Cin * kh * kw, Cout_padded) matrix with the output channel fastest,
    the entry conv padded to a multiple of 32 output channels and the
    others to a multiple of 8. The avd conv is fp32 (h1, 9) in both."""

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
            if self.w1.dtype == torch.bfloat16:
                packed = []
                for k, b in ((self.w1, self.b1), (self.k2, self.b2),
                             (self.k3, self.b3), (self.k4, self.b4)):
                    packed += [pack_mma(k), _pad_vec(
                        b.float(), _round_up(k.shape[0], TC_BN))]
            else:
                packed = self._pack_fp32(h1, cin)
            if self.stride == 2:
                packed += [self.avd_k.float().reshape(h1, 9).contiguous(),
                           self.avd_b.float().contiguous()]
        object.__setattr__(self, "packed", tuple(packed))

    def _pack_fp32(self, h1, cin):
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
        return packed

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
    """The fp32 body's block: its output tile, x1 chunk (stride 2) and
    shared memory: ``off_b`` is the byte offset of the second buffer,
    ``smem`` the total."""
    th: int
    tw: int
    chunk: int
    off_b: int
    smem: int


def plan(stride: int, elem: int, c_in: int, channels: Tuple[int, ...],
         batch: int, out_hw: Tuple[int, int], sms: int) -> Optional[Plan]:
    """The fp32 body's tile that fits ``SMEM_LIMIT`` with the least work,
    counting the recomputed halo, on a card of ``sms`` SMs (a grid smaller
    than that pays for its idle SMs), or None. ``elem``: bytes of the
    activation dtype.

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
            cost = tiles * macs * max(1.0, sms / tiles)
            key = (cost, -th * tw, -chunk)
            if best_key is None or key < best_key:
                best, best_key = Plan(th, tw, chunk, off_b, smem), key
    return best


@dataclass(frozen=True)
class TcStage:
    """One GEMM stage of the bf16 body: a 1x1 (``taps`` 1) or 3x3 (9) conv
    of ``cin`` to ``cout`` channels over a map, in items of (image, ``th``
    x ``tw`` output tile, 64 output channels); ``mt``: 16-row MMA tiles a
    warp (an item is 32 ``mt`` pixels). ``kc``: input channels of a
    K-slice."""
    cin: int
    cout: int
    taps: int
    kc: int
    mt: int
    th: int
    tw: int
    tiles_y: int
    tiles_x: int

    @property
    def nk(self) -> int:
        return -(-self.cin // self.kc)

    @property
    def nblk(self) -> int:
        return -(-self.cout // TC_BN)

    def items(self, batch: int) -> int:
        return batch * self.tiles_y * self.tiles_x * self.nblk

    @property
    def pitch(self) -> int:
        """Channels a pixel of this stage's input has when it is read
        pixel-major (a 3x3 stage's source): cin, zero-padded to whole
        chunks."""
        return self.nk * self.kc

    @property
    def row_bytes(self) -> int:
        """A weight slice's row pitch, and a 3x3 stage's staged pixel's:
        kc + 8 bf16 (16-byte units, odd, so ldmatrix's 8 rows hit 8 bank
        groups)."""
        return (self.kc + 8) * 2

    @property
    def stage_bytes(self) -> int:
        """Shared memory of one step of staged input: a 3x3 stage's chunk
        of its tile with the one-pixel halo, pixel-major at ``row_bytes``;
        the entry's tile channel-major, two chunks a step (one if it has
        one), kc rows each of th tw + 8 bf16 (odd in 16-byte units, for
        ldmatrix .trans)."""
        if self.taps == 9:
            return (self.th + 2) * (self.tw + 2) * self.row_bytes
        return min(2, self.nk) * self.kc * (self.th * self.tw + 8) * 2

    @property
    def buf_bytes(self) -> int:
        return _round_up(self.stage_bytes, 128)

    @property
    def tile_bytes(self) -> int:
        """The epilogue's pixel-major tile of the item's outputs, 32 mt
        rows of 64 + 8 bf16, over the staging buffers."""
        return 32 * self.mt * (TC_BN + 8) * 2


@dataclass(frozen=True)
class TcPlan:
    """The bf16 body's launch: its four GEMM stages (the entry first, over
    the input's map), at stride 2 the avd conv and pool's half-resolution
    tile (``dw_th`` x ``dw_tw``; 0 x 0 at stride 1), the shared-memory
    layout (from ``off_act``, ``act_bytes`` that each stage splits into
    two staging buffers of its ``buf_bytes`` and then fills with its
    epilogue's tile, and where avd_pool keeps its x1 region and avd tile)
    and the grid (``sms`` x ``blocks_per_sm``)."""
    stride: int
    stages: Tuple[TcStage, ...]
    dw_th: int
    dw_tw: int
    off_act: int
    act_bytes: int
    smem: int
    blocks_per_sm: int
    grid: int

    @property
    def dw_bytes(self) -> int:
        """avd_pool's shared memory: the (2 th + 1) x (2 tw + 1) x1 pixels
        and the th x tw avd and pool tiles, 64 + 8 bf16 each."""
        if not self.dw_th:
            return 0
        npx = (2 * self.dw_th + 1) * (2 * self.dw_tw + 1)
        return (npx + 2 * self.dw_th * self.dw_tw) * (TC_BN + 8) * 2


def _tile_stage(cin, cout, taps, hw, batch, sms) -> TcStage:
    """The tile of a 1x1 or 3x3 stage over the map ``hw``, 16 pixels wide
    unless the map is at most 8 wide: 128 pixels (4 MMA rows a warp), or 64
    where 128 leaves fewer items than the card has SMs (measured on an
    H100, PERF.md §6: the larger tile was faster wherever it kept every SM
    busy)."""
    h, w = hw
    tw = 16 if w > 8 else 8
    for mt in (4, 2):
        th = 32 * mt // tw
        st = TcStage(cin, cout, taps, mma_chunk(cin), mt, th, tw,
                     -(-h // th), -(-w // tw))
        if st.items(batch) >= sms:
            break
    return st


def tc_plan(stride: int, c_in: int, channels: Tuple[int, ...], batch: int,
            in_hw: Tuple[int, int], sms: int,
            blocks_per_sm: Optional[int] = None) -> TcPlan:
    """The bf16 body's stages, shared memory and grid for one bottleneck on
    a card of ``sms`` SMs. ``blocks_per_sm``: what the card holds at this
    plan's shared memory (the launch asks the library); None plans with
    what shared memory alone allows, at most ``TC_MAX_BLOCKS_PER_SM``."""
    h1, h2, h3, h4 = channels
    out_hw = (-(-in_hw[0] // stride), -(-in_hw[1] // stride))
    dw = ((4, 16) if out_hw[1] > 8 else (8, 8)) if stride == 2 else (0, 0)
    stages = (_tile_stage(c_in, h1, 1, in_hw, batch, sms),) + tuple(
        _tile_stage(ci, co, 9, out_hw, batch, sms)
        for ci, co in ((h1, h2), (h2, h3), (h3, h4)))
    off_act = TC_BAR_BYTES + TC_SLOTS * TC_SLOT_BYTES
    act = max(max(2 * st.buf_bytes, st.tile_bytes) for st in stages)
    tp = TcPlan(stride, stages, *dw, off_act, act, 0, 0, 0)
    smem = off_act + max(act, tp.dw_bytes)
    if smem > SMEM_LIMIT:
        raise ValueError(f"no bf16 plan of channels {channels} fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    n = blocks_per_sm or min(TC_MAX_BLOCKS_PER_SM,
                             SMEM_PER_SM // (smem + 1024))
    return TcPlan(stride, stages, *dw, off_act, act, smem, n, sms * n)


def launch_plan(x: torch.Tensor, fp: FoldedCat) -> TcPlan:
    """The bf16 body's plan for ``x`` (on a card) on its card: every block
    must be resident (a cooperative launch), so plan again at what the card
    holds until the plan asks no more of it."""
    b, c_in, h, w = x.shape
    index = x.device.index
    tp = tc_plan(fp.stride, c_in, fp.channels, b, (h, w), sm_count(index))
    while True:
        n = min(tp.blocks_per_sm, _blocks_per_sm(index, fp.stride, tp.smem))
        if n == tp.blocks_per_sm:
            return tp
        tp = tc_plan(fp.stride, c_in, fp.channels, b, (h, w),
                     sm_count(index), n)


def _tc_params(x, out, mids, bar, fp: FoldedCat, tp: TcPlan) -> _Params:
    """The ``tc::Params`` of one launch. ``mids``: the pixel-major
    intermediates, each (B, h, w, channels): at stride 1 x1, x2 and x3, the
    sources of stages 1-3 at their ``pitch``; at stride 2 x1 at full
    resolution (h1 rounded up to 64, the entry's output) before them, and
    the avd output in x1's place."""
    b, c_in, in_h, in_w = x.shape
    h1, h2, h3, _ = fp.channels
    out_h, out_w = out.shape[2:]
    w = fp.packed
    srcs = [x] + mids[-3:]
    dsts = mids[:1] + mids[-2:] + [None] if tp.stride == 2 else mids + [None]
    offsets = (-1 if tp.stride == 2 else 0, h1, h1 + h2, h1 + h2 + h3)
    stages = []
    for k, st in enumerate(tp.stages):
        src, mid = srcs[k], dsts[k]
        sh, sw = (in_h, in_w) if k == 0 else (out_h, out_w)
        stages.append(_Stage(
            w[2 * k].data_ptr(), w[2 * k + 1].data_ptr(), src.data_ptr(),
            None if mid is None else mid.data_ptr(),
            c_in if k == 0 else st.pitch,
            0 if mid is None else mid.shape[3], sh, sw, st.cin, st.cout,
            offsets[k], st.kc, st.nk, st.taps, st.nblk, st.mt, st.th, st.tw,
            st.tiles_y, st.tiles_x, st.items(b), st.buf_bytes))
    dw_tiles = ((-(-out_h // tp.dw_th), -(-out_w // tp.dw_tw))
                if tp.stride == 2 else (0, 0))
    return _Params(
        (_Stage * 4)(*stages), out.data_ptr(),
        w[8].data_ptr() if tp.stride == 2 else None,
        w[9].data_ptr() if tp.stride == 2 else None,
        bar.data_ptr(), b, out.shape[1], out_h, out_w, tp.off_act,
        tp.dw_th, tp.dw_tw, *dw_tiles,
        b * dw_tiles[0] * dw_tiles[1] * tp.stages[0].nblk)


def _tc_intermediates(x, tp: TcPlan, out_hw):
    """The pixel-major intermediates ``_tc_params`` takes, uninitialised:
    every place a stage reads is written by the stage before."""
    b, _, in_h, in_w = x.shape
    mids = [torch.empty((b, *out_hw, st.pitch), dtype=x.dtype,
                        device=x.device) for st in tp.stages[1:]]
    if tp.stride == 2:
        entry = tp.stages[0]
        mids.insert(0, torch.empty((b, in_h, in_w, entry.nblk * TC_BN),
                                   dtype=x.dtype, device=x.device))
    return mids


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
    out = torch.empty((b, out_c, *out_hw), dtype=x.dtype, device=x.device)
    lib = _library()
    if x.dtype == torch.bfloat16:
        name = f"fused_cat_s{s}_bf16"
        tp = launch_plan(x, fp)
        mids = _tc_intermediates(x, tp, out_hw)
        bar = torch.zeros(1, dtype=torch.int32, device=x.device)
        params = _tc_params(x, out, mids, bar, fp, tp)
        check_launch(lib.fused_cat_bf16(
            ctypes.byref(params), s, tp.grid, tp.smem,
            current_stream(x.device)), name)
    else:
        name = f"fused_cat_s{s}_f32"
        p = plan(s, x.element_size(), c_in, channels, b, out_hw,
                 sm_count(x.device.index))
        if p is None:
            raise ValueError(f"no tile of channels {channels} fits "
                             f"{SMEM_LIMIT} bytes of shared memory")
        ptrs = ([t.data_ptr() for t in fp.packed]
                + [None] * (10 - len(fp.packed)))
        check_launch(getattr(lib, name)(
            x.data_ptr(), out.data_ptr(), *ptrs, b, c_in, h, w, *channels,
            *out_hw, p.th, p.tw, p.chunk, p.off_b, p.smem,
            current_stream(x.device)), name)
    if s == 2:
        S2_LAUNCHES += 1
    else:
        S1_LAUNCHES += 1
    return out
