"""Fused bilinear upsample (align_corners=True) + class argmax.

Counterpart of the Pallas TPU kernel
``dasemanticsegmentationaml_tpu/ops/pallas/upsample_argmax.py::
upsample_argmax`` (:252). On a CUDA tensor the wrapper launches the
hand-written Hopper kernel ``csrc/upsample_argmax.cu`` (design, numerics
and bound are noted there); on a CPU tensor it runs the plain PyTorch
version ``upsample_argmax_reference``, which computes the same two-tap
formula with separate fp32 multiplies and adds (``ops/resize.py::
upsample_two_tap``), then ``torch.argmax``, and therefore the same bits,
for non-finite logits too (the first NaN wins). Both take their taps from
``ops/resize.py::_align_corners_taps``, the numbers the JAX package uses;
the kernel's column segments come from ``ops/resize.py::tap_ranges``.

The custom op ``dseg::upsample_argmax(Tensor logits, int out_h, int
out_w) -> Tensor`` is registered here: the kernel's launcher on CUDA, the
plain version on the CPU, and a shape function that keeps the batch
symbolic. The wrapper calls the op while ``torch.export`` traces, which
keeps it as one node, so a serving artifact (``utils/export.py``)
carries the kernel, and a process that loads one imports this module and
nothing of the model; eager calls on a card go to the launcher directly.

Eval inference (reference train.py:36-38): the main head's stride-8
logits, upsampled to the input size (model_stages.py:240), then the class
argmax (utils.py:120-122).

A row window (``ops/resize.py::RowWindow``, the height-sharded eval of
``parallel/spatial.py``) computes only the global output rows ``[y0,
y1)`` from a band of logits rows: the launch passes the global taps of
those rows, rebased to the band's first row, the band's rows as ``h`` and
``y1 - y0`` as the output height. The kernel reads ``h`` only as the
plane's size and ``H`` only as its own output's height, so its source is
the same for a window; a window's taps are cached apart (``taps_on``).
The custom op ``dseg::upsample_argmax_window(Tensor logits, int in_h, int
out_h, int out_w, int base, int y0, int y1) -> Tensor`` (``in_h`` and
``out_h`` the global logits and output heights) is the window's node in a
height-sharded serving artifact (``utils/export.py::
export_inference_spatial``): the same launch on CUDA, the plain version on
the CPU, a (B, y1 - y0, out_w) shape function.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..resize import RowWindow, check_window, ranges_on, taps_on, upsample_two_tap
from . import OP_NAMESPACE
from .build import check_launch, current_stream, load_library, sm_count

#: kernel launches made by ``upsample_argmax`` in this process; a run sets
#: it to 0 and reads it afterwards to show the path went through the kernel
LAUNCHES = 0
#: of those, the launches of a row window (the height-sharded eval and
#: serving)
WINDOW_LAUNCHES = 0

#: threads per block (csrc/upsample_argmax.cu::kThreads; ``_library``
#: checks that the two agree)
THREADS = 256
#: the most shared memory a block stages its band's labels in: the 48 KB a
#: block takes without opting in to more
STAGE_LIMIT = 48 * 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 8 + [_P]
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("upsample_argmax")
    for fn in (lib.upsample_argmax_f32, lib.upsample_argmax_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    # the geometry is set here and laid out there: they must agree
    lib.upsample_argmax_stage_bytes.argtypes = [_I]
    if lib.upsample_argmax_threads() != THREADS or any(
            lib.upsample_argmax_stage_bytes(n) != stage_bytes(n)
            for n in (1, 31, 32, 4096, 11915)):
        raise RuntimeError("csrc/upsample_argmax.cu and ops/cuda/"
                           "upsample_argmax.py disagree on THREADS or "
                           "stage_bytes")
    return lib


def stage_bytes(n: int) -> int:
    """Shared memory that stages a band of ``n`` int32 labels: one pad
    word every 32 (csrc/upsample_argmax.cu::stage_words)."""
    return 4 * (n + n // 32 + 1)


@functools.lru_cache(maxsize=256)
def band_geometry(b: int, out_h: int, out_w: int, w: int, sms: int
                  ) -> Tuple[int, bool]:
    """(rows per band, staged). About two column segments a thread (2 *
    THREADS / w output rows), halved while the grid has fewer than two
    blocks per SM and a block still has a segment for every thread; then
    cut until the band's labels fit ``STAGE_LIMIT``. A single row that
    does not fit is stored without staging."""
    full = -(-THREADS // w)
    rows = max(1, min(out_h, -(-2 * THREADS // w)))
    while rows > full and b * -(-out_h // rows) < 2 * sms:
        rows = max(full, -(-rows // 2))
    while rows > 1 and stage_bytes(rows * out_w) > STAGE_LIMIT:
        rows -= 1
    return rows, stage_bytes(rows * out_w) <= STAGE_LIMIT


def upsample_argmax_reference(logits: torch.Tensor, out_hw: Tuple[int, int],
                              window: Optional[RowWindow] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version: (B, C, h, w) fp32/bf16 -> (B, H, W) int32.

    Rows first, then columns (JAX resize.py:109-112); each product and sum
    is its own fp32 op, as in the kernel; ``torch.argmax`` picks the first
    NaN, otherwise the first of the largest. ``window``: as
    ``upsample_argmax``'s."""
    return upsample_two_tap(logits, out_hw, window).argmax(1).to(torch.int32)


def upsample_argmax(logits: torch.Tensor, out_hw: Tuple[int, int],
                    window: Optional[RowWindow] = None) -> torch.Tensor:
    """(B, C, h, w) contiguous fp32 or bf16 logits -> (B, H, W) int32
    argmax of their align_corners bilinear upsample to ``out_hw``.

    While ``torch.export`` traces, this calls the custom op
    ``dseg::upsample_argmax``, so that the traced graph
    (``utils/export.py``) holds the kernel as one node; otherwise it calls
    the op's CUDA implementation directly: the dispatcher's path to it
    costs the host about 8 us a call on an H100's host (``chip_smoke.py
    --baseline``, ``time_dispatch``). A CUDA tensor always goes through
    the kernel: a failed build, load or launch raises. A CPU tensor goes
    through the plain version.

    ``window``: the height-sharded form. ``logits`` is a band of the
    global logits starting at row ``window.base`` and holding every tap of
    the global output rows ``[window.y0, window.y1)``; ``out_hw`` is those
    rows' (y1 - y0, W). The result is those rows of the full call's, bit
    for bit. While exporting (and on the CPU) a window calls the op
    ``dseg::upsample_argmax_window``."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    _check(logits, out_h, out_w)
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {logits.device}")
    if window is not None:
        window = RowWindow(*(int(v) for v in window))
        check_window(window, logits.shape[2], out_h)
        if logits.device.type == "cuda" and not torch.compiler.is_exporting():
            return _launch(logits, out_h, out_w, window)
        return _window_op(logits, window.h, window.H, out_w, window.base,
                          window.y0, window.y1)
    if logits.device.type == "cuda" and not torch.compiler.is_exporting():
        return _upsample_argmax_launch(logits, out_h, out_w)
    return _upsample_argmax_op(logits, out_h, out_w)


def _check(logits: torch.Tensor, out_h: int, out_w: int) -> None:
    """Raise on what neither version takes (nothing here reads the batch,
    which may be symbolic while a program is exported)."""
    if logits.dim() != 4:
        raise ValueError(f"logits must be (B, C, h, w), got {tuple(logits.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous (B, C, h, w)")
    _, c, h, w = logits.shape
    if min(out_h, out_w, c, h, w) < 1:
        raise ValueError(f"empty shape: logits {tuple(logits.shape)} -> "
                         f"{(out_h, out_w)}")


@torch.library.custom_op(f"{OP_NAMESPACE}::upsample_argmax",
                         mutates_args=(), device_types="cpu")
def _upsample_argmax_op(logits: torch.Tensor, out_h: int,
                        out_w: int) -> torch.Tensor:
    """``dseg::upsample_argmax`` on the CPU: the plain version."""
    return upsample_argmax_reference(logits, (out_h, out_w))


@_upsample_argmax_op.register_fake
def _upsample_argmax_shape(logits, out_h, out_w):
    return logits.new_empty((logits.shape[0], out_h, out_w),
                            dtype=torch.int32)


@_upsample_argmax_op.register_kernel("cuda")
def _upsample_argmax_launch(logits: torch.Tensor, out_h: int,
                            out_w: int) -> torch.Tensor:
    """``dseg::upsample_argmax`` on a card: one launch of the kernel. A
    loaded artifact calls the op directly, so the checks run here again,
    with the 32-bit index limit, on the concrete batch."""
    _check(logits, out_h, out_w)
    return _launch(logits, out_h, out_w, None)


@torch.library.custom_op(f"{OP_NAMESPACE}::upsample_argmax_window",
                         mutates_args=(), device_types="cpu")
def _window_op(logits: torch.Tensor, in_h: int, out_h: int, out_w: int,
               base: int, y0: int, y1: int) -> torch.Tensor:
    """``dseg::upsample_argmax_window`` on the CPU: the plain version of
    the window ``RowWindow(y0, y1, in_h, out_h, base)``."""
    return upsample_argmax_reference(logits, (y1 - y0, out_w),
                                     RowWindow(y0, y1, in_h, out_h, base))


@_window_op.register_fake
def _window_shape(logits, in_h, out_h, out_w, base, y0, y1):
    return logits.new_empty((logits.shape[0], y1 - y0, out_w),
                            dtype=torch.int32)


@_window_op.register_kernel("cuda")
def _window_launch(logits: torch.Tensor, in_h: int, out_h: int, out_w: int,
                   base: int, y0: int, y1: int) -> torch.Tensor:
    """``dseg::upsample_argmax_window`` on a card: one launch over the
    window's rows (checked again, as a loaded artifact calls it)."""
    window = RowWindow(y0, y1, in_h, out_h, base)
    _check(logits, y1 - y0, out_w)
    check_window(window, logits.shape[2], y1 - y0)
    return _launch(logits, y1 - y0, out_w, window)


def _launch(logits: torch.Tensor, out_h: int, out_w: int,
            window: Optional[RowWindow]) -> torch.Tensor:
    """One launch of the kernel over ``out_h`` output rows: all of them,
    or the window's from its rebased taps."""
    global LAUNCHES, WINDOW_LAUNCHES
    b, c, h, w = logits.shape
    if max(b * c * h * w, b * out_h * out_w, 4 * w) > _INT_MAX:
        raise ValueError("the shape exceeds the kernel's 32-bit indices: "
                         f"{tuple(logits.shape)} -> {(out_h, out_w)}")
    dev = logits.device
    out = torch.empty((b, out_h, out_w), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    lib = _library()
    fn = (lib.upsample_argmax_f32 if logits.dtype == torch.float32
          else lib.upsample_argmax_bf16)
    lo_y, hi_y, ty = taps_on(h, out_h, dev, window)
    _, hi_x, tx = taps_on(w, out_w, dev)
    xr = ranges_on(w, out_w, dev)
    rows, staged = band_geometry(b, out_h, out_w, w, sm_count(dev.index))
    check_launch(fn(logits.data_ptr(), out.data_ptr(), lo_y.data_ptr(),
                    hi_y.data_ptr(), ty.data_ptr(), hi_x.data_ptr(),
                    tx.data_ptr(), xr.data_ptr(), b, c, h, w, out_h, out_w,
                    rows, int(staged), current_stream(dev)),
                 "upsample_argmax")
    LAUNCHES += 1
    WINDOW_LAUNCHES += window is not None
    return out
