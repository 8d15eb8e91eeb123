"""Fused bilinear upsample (align_corners=True) + cross-entropy(ignore).

Counterpart of the Pallas TPU kernel
``dasemanticsegmentationaml_tpu/ops/pallas/fused_ce.py::
cross_entropy_upsampled`` (:303), a forward and a backward kernel under a
custom VJP (:240-260). The supervised trainer sends every head through it
(JAX supervised.py:64-76): the mean CE(ignore) of each head's logits
after the align_corners upsample to the input size (reference
train.py:86-89, model_stages.py:240-242), without writing the upsampled
logits or their gradient to device memory.

On a CUDA tensor ``cross_entropy_upsampled`` is a ``torch.autograd.
Function`` whose forward and backward launch the hand-written Hopper
kernels of ``csrc/fused_ce.cu`` (design, numerics and bound are noted
there); a failed build, load or launch raises. On a CPU tensor it runs the
plain PyTorch version ``cross_entropy_upsampled_reference``: the two-tap
interpolation of ``ops/resize.py::upsample_two_tap``, then
``ops/losses.py::cross_entropy_ignore``, with the gradient by autograd.

Unlike the TPU kernel, whose bf16 taps keep fp32 logits on the XLA path
(fused_ce.py:327-334), the CUDA kernels interpolate in exact fp32
arithmetic for fp32 and bf16 logits alike, so on a card both
``--dtype float32`` and ``--dtype bfloat16`` go through them. The loss is
fp32; the gradient comes back in the logits' dtype (fused_ce.py:257).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..losses import cross_entropy_ignore
from ..resize import _align_corners_taps, ranges_on, taps_on, upsample_two_tap
from .build import check_launch, current_stream, load_library, sm_count

#: kernel launches made by ``cross_entropy_upsampled``'s forward and its
#: backward in this process; a run sets them to 0 and reads them after
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

#: the kernels keep one pixel's class logits in registers
MAX_CLASSES = 32
#: threads per block of the band kernels (csrc/fused_ce.cu::kThreads;
#: ``_library`` checks that the two agree)
THREADS = 256
#: the most shared memory a block of an H100 can take (227 KB); the
#: geometry is sized here, and a launch past the card's own limit fails
SMEM_LIMIT = 232448
#: the most source rows a backward band holds
MAX_BAND_ROWS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGTYPES = [_P] * 8 + [_I] * 8 + [_P] * 5
_BWD_ARGTYPES = [_P] * 11 + [_I] * 9 + [_P] * 4
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("fused_ce")
    for fn, argtypes in ((lib.fused_ce_fwd_f32, _FWD_ARGTYPES),
                         (lib.fused_ce_fwd_bf16, _FWD_ARGTYPES),
                         (lib.fused_ce_bwd_f32, _BWD_ARGTYPES),
                         (lib.fused_ce_bwd_bf16, _BWD_ARGTYPES)):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    # the geometry is set here and laid out there: they must agree
    lib.fused_ce_bwd_smem_bytes.argtypes = [_I] * 4
    if lib.fused_ce_threads() != THREADS or any(
            lib.fused_ce_bwd_smem_bytes(*g) != bwd_smem_bytes(*g)
            for g in ((19, 64, 4, 8), (32, 1, 1, 1), (3, 500, 8, 32))):
        raise RuntimeError("csrc/fused_ce.cu and ops/cuda/fused_ce.py "
                           "disagree on THREADS or bwd_smem_bytes")
    return lib


def band_rows(in_size: int, out_size: int, k: int) -> np.ndarray:
    """The backward's band plan: (ceil(in_size / k) + 1,) int32. Band n
    holds the source rows [n*k, (n+1)*k) and walks the output rows
    [plan[n], plan[n+1]), those whose ``lo`` row tap lies in the band;
    their ``hi`` tap lies in the band or is its edge row (n+1)*k, the next
    band's first, whose two partials the edge kernel adds."""
    lo, _, _ = _align_corners_taps(in_size, out_size)
    starts = np.searchsorted(lo, np.arange(0, in_size, k), "left")
    return np.append(starts, out_size).astype(np.int32)


def bwd_smem_bytes(c: int, w: int, k: int, rows_per_pass: int) -> int:
    """Shared memory of one backward block, as csrc/fused_ce.cu::
    bwd_smem_bytes lays it out: fp32 dX of k + 1 rows and two column sums
    per pass row."""
    return 4 * c * ((k + 1) * w + rows_per_pass * (2 * w + 1))


@functools.lru_cache(maxsize=256)
def fwd_rows_per_band(b: int, out_h: int, w: int, sms: int) -> int:
    """Output rows per forward block: about two column segments a thread
    (2 * THREADS / w rows), halved while the grid has fewer than two
    blocks per SM."""
    rows = max(1, min(out_h, -(-2 * THREADS // w)))
    while rows > 1 and b * -(-out_h // rows) < 2 * sms:
        rows = -(-rows // 2)
    return rows


@functools.lru_cache(maxsize=256)
def bwd_geometry(b: int, c: int, h: int, w: int, sms: int
                 ) -> Tuple[int, int]:
    """(k, rows_per_pass) of the backward. k source rows a band: the most
    of 8, 4 and 2 that still gives 1.5 blocks per SM (at least 2, so that
    the edge rows are at most half of dX), or h; about two column segments
    a thread a pass (2 * THREADS / w output rows). Both shrink to fit the
    shared memory; ValueError if one row does not fit."""
    k = next((k for k in (MAX_BAND_ROWS, MAX_BAND_ROWS // 2)
              if 2 * b * -(-h // k) >= 3 * sms), 2)
    k = min(k, h)
    rpp = max(1, min(32, 2 * THREADS // w))
    while bwd_smem_bytes(c, w, k, rpp) > SMEM_LIMIT and rpp > 1:
        rpp //= 2
    while bwd_smem_bytes(c, w, k, rpp) > SMEM_LIMIT and k > 1:
        k -= 1
    if bwd_smem_bytes(c, w, k, rpp) > SMEM_LIMIT:
        raise ValueError(f"{c} classes x {w} source columns do not fit the "
                         f"backward's shared memory ({SMEM_LIMIT} bytes)")
    return k, rpp


@functools.lru_cache(maxsize=64)
def _bands_on(in_size: int, out_size: int, k: int, device: torch.device):
    with torch.inference_mode(False):
        return torch.from_numpy(band_rows(in_size, out_size, k)).to(device)


def cross_entropy_upsampled_reference(logits: torch.Tensor,
                                      labels: torch.Tensor,
                                      out_hw: Tuple[int, int],
                                      ignore_index: int = 255
                                      ) -> torch.Tensor:
    """Plain PyTorch version: upsample (fp32, two taps) then mean
    CE(ignore); differentiable by autograd."""
    return cross_entropy_ignore(upsample_two_tap(logits, out_hw), labels,
                                ignore_index)


class _FusedCE(torch.autograd.Function):
    """Forward and backward both launch kernels; N stays on the device."""

    @staticmethod
    def forward(ctx, logits, labels, out_hw, ignore_index):
        global FWD_LAUNCHES
        b, c, h, w = logits.shape
        out_h, out_w = out_hw
        dev = logits.device
        lo_y, hi_y, ty = taps_on(h, out_h, dev)
        _, hi_x, tx = taps_on(w, out_w, dev)
        xr = ranges_on(w, out_w, dev)
        rows = fwd_rows_per_band(b, out_h, w, sm_count(dev.index))
        n_parts = b * -(-out_h // rows)
        part_sum = torch.empty(n_parts, dtype=torch.float32, device=dev)
        part_cnt = torch.empty(n_parts, dtype=torch.int32, device=dev)
        loss = torch.empty((), dtype=torch.float32, device=dev)
        n = torch.empty((), dtype=torch.float32, device=dev)
        lib = _library()
        fn = (lib.fused_ce_fwd_f32 if logits.dtype == torch.float32
              else lib.fused_ce_fwd_bf16)
        check_launch(fn(
            logits.data_ptr(), labels.data_ptr(), lo_y.data_ptr(),
            hi_y.data_ptr(), ty.data_ptr(), hi_x.data_ptr(), tx.data_ptr(),
            xr.data_ptr(), b, c, h, w, out_h, out_w, ignore_index, rows,
            part_sum.data_ptr(), part_cnt.data_ptr(), loss.data_ptr(),
            n.data_ptr(), current_stream(dev)), "fused_ce forward")
        FWD_LAUNCHES += 1
        ctx.save_for_backward(logits, labels, n)
        ctx.out_hw = out_hw
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, grad):
        global BWD_LAUNCHES
        logits, labels, n = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        b, c, h, w = logits.shape
        out_h, out_w = ctx.out_hw
        dev = logits.device
        lo_y, hi_y, ty = taps_on(h, out_h, dev)
        _, hi_x, tx = taps_on(w, out_w, dev)
        xr = ranges_on(w, out_w, dev)
        k, rpp = bwd_geometry(b, c, h, w, sm_count(dev.index))
        bands = _bands_on(h, out_h, k, dev)
        n_bands = bands.numel() - 1
        g = grad.float().contiguous()
        # the partials of the bands' edge rows: (B, bands, C, w) fp32 each
        edges = torch.empty((2, b, n_bands, c, w), dtype=torch.float32,
                            device=dev)
        dx = torch.empty_like(logits)
        lib = _library()
        fn = (lib.fused_ce_bwd_f32 if logits.dtype == torch.float32
              else lib.fused_ce_bwd_bf16)
        check_launch(fn(
            logits.data_ptr(), labels.data_ptr(), lo_y.data_ptr(),
            hi_y.data_ptr(), ty.data_ptr(), hi_x.data_ptr(), tx.data_ptr(),
            xr.data_ptr(), bands.data_ptr(), g.data_ptr(), n.data_ptr(), b,
            c, h, w, out_h, out_w, ctx.ignore_index, k, rpp,
            edges[0].data_ptr(), edges[1].data_ptr(), dx.data_ptr(),
            current_stream(dev)), "fused_ce backward")
        BWD_LAUNCHES += 1
        return dx, None, None, None


def cross_entropy_upsampled(logits: torch.Tensor, labels: torch.Tensor,
                            out_hw: Tuple[int, int],
                            ignore_index: int = 255) -> torch.Tensor:
    """Mean CE(ignore) of the align_corners upsample of ``logits`` to
    ``out_hw``, an fp32 scalar; 0 (and a zero gradient) when no pixel is
    valid.

    logits: (B, C, h, w) contiguous fp32 or bf16; labels: (B, H, W) int32
    (any integer type on the CPU). A CUDA tensor always goes through the
    kernels; a CPU tensor through the plain version."""
    if logits.dim() != 4:
        raise ValueError(f"logits must be (B, C, h, w), got {tuple(logits.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous (B, C, h, w)")
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    b, c, h, w = logits.shape
    if tuple(labels.shape) != (b, out_h, out_w):
        raise ValueError(f"labels {tuple(labels.shape)} do not match "
                         f"{(b, out_h, out_w)}")
    if min(b, c, h, w, out_h, out_w) < 1:
        raise ValueError(f"empty shape: logits {tuple(logits.shape)} -> "
                         f"{(out_h, out_w)}")
    if logits.device.type == "cpu":
        return cross_entropy_upsampled_reference(logits, labels,
                                                 (out_h, out_w), ignore_index)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    if labels.device != logits.device or labels.dtype != torch.int32 \
            or not labels.is_contiguous():
        raise TypeError(f"labels must be contiguous int32 on {logits.device}, "
                        f"got {labels.dtype} on {labels.device}")
    if c > MAX_CLASSES:
        raise ValueError(f"{c} classes: the kernel takes at most {MAX_CLASSES}")
    bwd_geometry(b, c, h, w, 1)  # raises if one row does not fit
    if b * out_h > _INT_MAX or out_w > _INT_MAX:
        raise ValueError("a dimension exceeds the kernel's int range")
    return _FusedCE.apply(logits, labels, (out_h, out_w), int(ignore_index))
