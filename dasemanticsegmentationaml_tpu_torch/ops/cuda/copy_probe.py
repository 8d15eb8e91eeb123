"""Identity copies of a device buffer, three ways: the copy-bandwidth probe.

Counterpart of the Pallas TPU kernels of the JAX package's two DMA probes:
``tools/probe_pallas_dma.py::pallas_copy`` (:34, a row-block copy through
Pallas's auto-pipeline) becomes ``copy_block``; ``tools/probe_dma_manual.py::
_call`` (:132) with ``_hbm2hbm_kernel`` (:105, HBM->HBM, 8 copies in flight)
becomes ``copy_direct``, and with ``_bounce_kernel`` (:54, an n_slots-deep
HBM->VMEM->HBM ring) becomes ``copy_bounce``, a TMA bulk-copy ring through
shared memory. The kernels are in ``csrc/copy_probe.cu`` (design and bound
are noted there); ``tools/probe_copy.py`` times them.

On a CUDA tensor each wrapper launches its kernel; a failed build, load or
launch raises. On a CPU tensor it runs the plain version, ``copy_plain``
(``x.clone()``). Both devices take the same inputs: a contiguous bf16
tensor whose size and address are multiples of 16 bytes, and, if given, an
``out`` of the same shape and dtype that does not overlap it. Anything else
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from .build import check_launch, current_stream, load_library, sm_count

#: kernel launches made by the wrappers in this process; a run sets them to
#: 0 and reads them afterwards to show that its path went through the kernels
BLOCK_LAUNCHES = 0
DIRECT_LAUNCHES = 0
#: ``copy_bounce`` launches by ring depth
BOUNCE_LAUNCHES: Dict[int, int] = {2: 0, 8: 0}

#: the ring depths ``copy_bounce`` is built for (the TPU probe's two)
SLOTS = (2, 8)
#: chunk bytes when none is given (the probe's sweep found no better size
#: for either depth on an H100)
DEFAULT_CHUNK = 16 * 1024
#: dynamic shared memory one block may take on an H100 (227 KB)
SMEM_LIMIT = 232_448
#: bytes in front of the ring that hold its mbarriers (csrc kRingOffset)
RING_OFFSET = 128
#: an mbarrier's transaction count stays under 2^20 bytes
_MAX_TX = 2**20 - 1
ALIGN = 16
#: the probe's buffer is bf16 (the kernels move bytes and never look at them)
DTYPES = (torch.bfloat16,)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("copy_probe")
    for fn, argtypes in ((lib.copy_block, [_P, _P, _L, _P]),
                         (lib.copy_direct, [_P, _P, _L, _I, _P]),
                         (lib.copy_bounce, [_P, _P, _L, _I, _I, _I, _P])):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def copy_plain(x: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: ``x.clone()``, or ``x`` written into ``out``."""
    return x.clone() if out is None else out.copy_(x)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _checked(x: torch.Tensor,
             out: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Raise on what the kernels do not take; return the output tensor
    (``out``, or a new one on a CUDA device; None for a CPU ``x`` without
    ``out``)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be one of {DTYPES}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    n = _nbytes(x)
    if n % ALIGN:
        raise ValueError(f"x holds {n} bytes, not a multiple of {ALIGN}")
    if x.data_ptr() % ALIGN:
        raise ValueError(f"x is not {ALIGN}-byte aligned")
    if out is None:
        return None if x.device.type == "cpu" else torch.empty_like(x)
    if (out.shape != x.shape or out.dtype != x.dtype
            or out.device != x.device):
        raise ValueError(f"out is {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}, x is {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if out.data_ptr() % ALIGN:
        raise ValueError(f"out is not {ALIGN}-byte aligned")
    if n and abs(out.data_ptr() - x.data_ptr()) < n:
        raise ValueError("out overlaps x")
    return out


def copy_block(x: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy ``x`` (into ``out``) with one 16-byte load and store per
    thread, a plain grid of 4 KB blocks."""
    global BLOCK_LAUNCHES
    dst = _checked(x, out)
    if x.device.type == "cpu":
        return copy_plain(x, out)
    check_launch(_library().copy_block(
        x.data_ptr(), dst.data_ptr(), _nbytes(x) // ALIGN,
        current_stream(x.device)), "copy_block")
    BLOCK_LAUNCHES += 1
    return dst


def copy_direct(x: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy ``x`` (into ``out``) with a persistent grid whose threads keep
    8 independent 16-byte loads in flight."""
    global DIRECT_LAUNCHES
    dst = _checked(x, out)
    if x.device.type == "cpu":
        return copy_plain(x, out)
    check_launch(_library().copy_direct(
        x.data_ptr(), dst.data_ptr(), _nbytes(x) // ALIGN,
        sm_count(x.device.index or 0), current_stream(x.device)),
        "copy_direct")
    DIRECT_LAUNCHES += 1
    return dst


def ring_fits(n_slots: int, chunk_bytes: int) -> bool:
    """Whether ``copy_bounce`` takes this ring: 2 or 8 slots of a positive
    multiple of 16 bytes under an mbarrier's 2^20, in 227 KB with the
    barriers."""
    return (n_slots in SLOTS and 0 < chunk_bytes <= _MAX_TX
            and chunk_bytes % ALIGN == 0
            and RING_OFFSET + n_slots * chunk_bytes <= SMEM_LIMIT)


def copy_bounce(x: torch.Tensor, out: Optional[torch.Tensor] = None,
                n_slots: int = 8,
                chunk_bytes: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Copy ``x`` (into ``out``) through an ``n_slots``-deep ring of
    ``chunk_bytes`` chunks in shared memory with TMA bulk copies, one
    block per SM."""
    if not ring_fits(n_slots, chunk_bytes):
        raise ValueError(f"no ring of {n_slots} slots of {chunk_bytes} bytes:"
                         f" {SLOTS} slots, chunks a multiple of {ALIGN} and "
                         f"RING_OFFSET + n_slots * chunk <= {SMEM_LIMIT}")
    dst = _checked(x, out)
    if x.device.type == "cpu":
        return copy_plain(x, out)
    check_launch(_library().copy_bounce(
        x.data_ptr(), dst.data_ptr(), _nbytes(x), n_slots, chunk_bytes,
        sm_count(x.device.index or 0), current_stream(x.device)),
        "copy_bounce")
    BOUNCE_LAUNCHES[n_slots] += 1
    return dst
