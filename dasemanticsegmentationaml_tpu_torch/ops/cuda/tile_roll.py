"""``roll(x, shift, dim=1)`` of a contiguous (R, C) tensor.

Counterpart of the Pallas TPU kernel ``tools/mosaic_roll_repro.py::
roll_once`` (:30; body ``_kernel`` :26): ``pltpu.roll(x, 1, 1)`` on an
(8, 128) tile, which Mosaic cannot lower for 16-bit data. On a CUDA tensor
``tile_roll`` launches the warp-shuffle rotate of ``csrc/tile_roll.cu``
(design and bound are noted there); a failed build, load or launch raises.
On a CPU tensor it runs the plain version, ``tile_roll_plain``: the JAX
repro's own workaround, two slices and a concatenate
(mosaic_roll_repro.py:12-14).

Both devices take float32, int32, bfloat16 and int16 and any integer
shift (negative shifts and shifts of C or more wrap modulo C). The kernel
moves each row in 16-byte vectors, so both raise on a row whose bytes are
not a multiple of 16 (C not a multiple of 4 for a 32-bit type, of 8 for a
16-bit one) and on a tensor that does not start on a 16-byte boundary; and
on another dtype and a tensor that is not 2-D and contiguous.
"""

from __future__ import annotations

import ctypes
import functools
import operator

import torch

from .build import check_launch, current_stream, load_library, sm_count

#: kernel launches made by ``tile_roll`` in this process; a run sets it to 0
#: and reads it afterwards to show that its path went through the kernel
LAUNCHES = 0

DTYPES = (torch.float32, torch.int32, torch.bfloat16, torch.int16)
#: the kernel's vector in bytes: a row's bytes and x's address are multiples
#: of it
ALIGN = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("tile_roll")
    lib.tile_roll.argtypes = [_P, _P, _L, _L, _I, _L, _I, _P]
    lib.tile_roll.restype = ctypes.c_int
    return lib


def tile_roll_plain(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Plain PyTorch version: the last ``shift mod C`` columns, then the
    rest (two slices and a ``torch.cat``)."""
    c = x.shape[1]
    s = operator.index(shift) % c
    if s == 0:
        return x.clone()
    return torch.cat([x[:, c - s:], x[:, :c - s]], dim=1)


def tile_roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """(R, C) -> (R, C): ``out[r, j] = x[r, (j - shift) mod C]``, as
    ``torch.roll(x, shift, 1)``."""
    global LAUNCHES
    shift = operator.index(shift)
    if x.dim() != 2:
        raise ValueError(f"x must be (R, C), got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be one of {DTYPES}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    rows, cols = x.shape
    if cols < 1:
        raise ValueError("x has no columns to roll")
    if cols * x.element_size() % ALIGN:
        raise ValueError(f"a row must hold a multiple of {ALIGN} bytes, got "
                         f"C = {cols} values of {x.element_size()} bytes")
    if x.data_ptr() % ALIGN:
        raise ValueError(f"x must start on a {ALIGN}-byte boundary")
    if x.device.type == "cpu":
        return tile_roll_plain(x, shift)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    check_launch(_library().tile_roll(
        x.data_ptr(), out.data_ptr(), rows, cols, x.element_size(),
        shift % cols,
        sm_count(x.device.index or 0), current_stream(x.device)), "tile_roll")
    LAUNCHES += 1
    return out
