"""Fused bilinear upsample (align_corners=True) + class argmax.

Counterpart of the Pallas TPU kernel
``dasemanticsegmentationaml_tpu/ops/pallas/upsample_argmax.py::
upsample_argmax`` (:252). On a CUDA tensor the wrapper launches the
hand-written Hopper kernel ``csrc/upsample_argmax.cu`` (design, numerics
and bound are noted there); on a CPU tensor it runs the plain PyTorch
version ``upsample_argmax_reference``, which computes the same two-tap
formula with separate fp32 multiplies and adds (``ops/resize.py::
upsample_two_tap``) and therefore the same bits. Both take their taps from
``ops/resize.py::_align_corners_taps``, the numbers the JAX package uses.

Eval inference (reference train.py:36-38): the main head's stride-8
logits, upsampled to the input size (model_stages.py:240), then the class
argmax (utils.py:120-122).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..resize import taps_on, upsample_two_tap
from .build import check_launch, current_stream, load_library

#: kernel launches made by ``upsample_argmax`` in this process; a run sets
#: it to 0 and reads it afterwards to show the path went through the kernel
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("upsample_argmax")
    for fn in (lib.upsample_argmax_f32, lib.upsample_argmax_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def upsample_argmax_reference(logits: torch.Tensor,
                              out_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version: (B, C, h, w) fp32/bf16 -> (B, H, W) int32.

    Rows first, then columns (JAX resize.py:109-112); each product and sum
    is its own fp32 op, as in the kernel."""
    return upsample_two_tap(logits, out_hw).argmax(1).to(torch.int32)


def upsample_argmax(logits: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, C, h, w) contiguous fp32 or bf16 logits -> (B, H, W) int32
    argmax of their align_corners bilinear upsample to ``out_hw``.

    A CUDA tensor always goes through the kernel: a failed build, load or
    launch raises. A CPU tensor goes through the plain version."""
    global LAUNCHES
    if logits.dim() != 4:
        raise ValueError(f"logits must be (B, C, h, w), got {tuple(logits.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous (B, C, h, w)")
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    b, c, h, w = logits.shape
    if min(out_h, out_w, c, h, w) < 1:
        raise ValueError(f"empty shape: logits {tuple(logits.shape)} -> "
                         f"{(out_h, out_w)}")
    if logits.device.type == "cpu":
        return upsample_argmax_reference(logits, (out_h, out_w))
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    if max(b, c, h, w, out_h, out_w) > _INT_MAX:
        raise ValueError("a dimension exceeds the kernel's int range")
    out = torch.empty((b, out_h, out_w), dtype=torch.int32,
                      device=logits.device)
    if b == 0:
        return out
    lib = _library()
    fn = (lib.upsample_argmax_f32 if logits.dtype == torch.float32
          else lib.upsample_argmax_bf16)
    lo_y, hi_y, ty = taps_on(h, out_h, logits.device)
    lo_x, hi_x, tx = taps_on(w, out_w, logits.device)
    check_launch(fn(logits.data_ptr(), out.data_ptr(), lo_y.data_ptr(),
                    hi_y.data_ptr(), ty.data_ptr(), lo_x.data_ptr(),
                    hi_x.data_ptr(), tx.data_ptr(), b, c, h, w, out_h, out_w,
                    current_stream(logits.device)), "upsample_argmax")
    LAUNCHES += 1
    return out
