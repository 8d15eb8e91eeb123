"""Identity copies of a device buffer, three ways: the copy-bandwidth probe.

Counterpart of the Pallas TPU kernels of the JAX package's two DMA probes:
``tools/probe_pallas_dma.py::pallas_copy`` (:34, a row-block copy through
Pallas's auto-pipeline) becomes ``copy_block``; ``tools/probe_dma_manual.py::
_call`` (:132) with ``_hbm2hbm_kernel`` (:105, HBM->HBM, 8 copies in flight)
becomes ``copy_direct``, and with ``_bounce_kernel`` (:54, an n_slots-deep
HBM->VMEM->HBM ring) becomes ``copy_bounce``, a TMA bulk-copy ring through
shared memory. The kernels are in ``csrc/copy_probe.cu`` (design and bound
are noted there); ``tools/probe_copy.py`` times them.

``copy_direct`` copies whole tiles of ``DIRECT_TILE`` 16-byte vectors (8
per thread of a 128-thread block), one contiguous span per block, a block
of more than one tile software-pipelined; ``direct_geometry`` splits the
tiles evenly over a grid sized from the work. ``copy_bounce`` splits its
ring of ``n_slots`` slots between loads ahead and ``stores`` left reading
their slots, and claims its chunks from a global counter as slots free up
(``Ring``). Each is bound by bytes: a copy of N bytes moves 2 N bytes,
0.160 ms for 256 MB at 3.35 TB/s. The defaults (``DIRECT_*``,
``BOUNCE_DEFAULTS``) are the fastest of ``tools/probe_copy.py``'s sweep on
an H100 by graph replay (PERF.md §6).

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
from typing import Dict, List, NamedTuple, Optional, Tuple

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
#: 16-byte vectors of one ``copy_direct`` tile: 8 per thread of a
#: 128-thread block (csrc kDirectTile)
DIRECT_TILE = 8 * 128
#: ``copy_direct``'s blocks resident per SM (its 128 threads take up to 85
#: registers each, so six fit)
DIRECT_RESIDENT = 6
#: ``copy_direct``'s tiles per block when none is given (0: a persistent
#: grid of the resident blocks)
DIRECT_TILES_PER_BLOCK = 1
#: shared memory of one SM on an H100 (228 KB), of which each resident
#: block leaves 1 KB to the system; one block may take 227 KB
SM_SMEM = 233_472
#: bytes in front of the ring that hold its mbarriers (csrc kRingOffset)
RING_OFFSET = 128
#: an mbarrier's transaction count stays under 2^20 bytes
_MAX_TX = 2**20 - 1
ALIGN = 16
#: the probe's buffer is bf16 (the kernels move bytes and never look at them)
DTYPES = (torch.bfloat16,)


class Ring(NamedTuple):
    """How ``copy_bounce`` runs a ring of a given depth."""

    #: stores left reading their slots while the others fill (1 .. depth - 1)
    stores: int
    #: bytes of one slot
    chunk_bytes: int
    #: issuing blocks per SM
    blocks_per_sm: int
    #: chunks claimed from a global counter as slots free up, instead of a
    #: static split over the blocks
    dynamic: bool


#: each depth's ring when no option is given
BOUNCE_DEFAULTS: Dict[int, Ring] = {2: Ring(1, 32 * 1024, 1, True),
                                    8: Ring(7, 8 * 1024, 2, True)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("copy_probe")
    for fn, argtypes in ((lib.copy_block, [_P, _P, _L, _P]),
                         (lib.copy_direct, [_P, _P, _L, _I, _L, _I, _P]),
                         (lib.copy_bounce,
                          [_P, _P, _L, _I, _I, _I, _I, _P, _P])):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


_CLAIMS: Dict[torch.device, torch.Tensor] = {}


def _claims(device: torch.device) -> torch.Tensor:
    """The dynamic ring's two counters on ``device``, zeroed once; each
    launch leaves them zeroed, and launches on one device run one at a
    time (one stream)."""
    if device not in _CLAIMS:
        _CLAIMS[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return _CLAIMS[device]


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


class DirectGeometry(NamedTuple):
    """``copy_direct``'s launch: ``grid`` blocks; block b copies the span
    of tiles [b * base + min(b, extra), + base + (b < extra)), the buffer's
    last tile cut at its end."""

    n16: int
    grid: int
    base: int
    extra: int

    def spans(self) -> List[Tuple[int, int]]:
        """Each block's [start, stop) in 16-byte vectors."""
        out = []
        for b in range(self.grid):
            first = b * self.base + min(b, self.extra)
            stop = first + self.base + (b < self.extra)
            out.append((first * DIRECT_TILE,
                        min(stop * DIRECT_TILE, self.n16)))
        return out


def direct_geometry(n16: int, sms: int,
                    tiles_per_block: int = DIRECT_TILES_PER_BLOCK
                    ) -> DirectGeometry:
    """Split ``n16`` 16-byte vectors into whole tiles over a grid sized
    from the work: about ``tiles_per_block`` tiles a block, but never fewer
    blocks than the card holds at once (``sms * DIRECT_RESIDENT``, or the
    tiles if fewer); ``tiles_per_block`` 0 is a persistent grid of exactly
    the resident blocks. As even as whole tiles allow: no block copies more
    than one tile more than another."""
    tiles = -(-n16 // DIRECT_TILE)
    resident = min(tiles, sms * DIRECT_RESIDENT)
    grid = (max(-(-tiles // tiles_per_block), resident) if tiles_per_block
            else resident)
    if grid == 0:
        return DirectGeometry(n16, 0, 0, 0)
    return DirectGeometry(n16, grid, *divmod(tiles, grid))


def copy_direct(x: torch.Tensor, out: Optional[torch.Tensor] = None,
                tiles_per_block: int = DIRECT_TILES_PER_BLOCK
                ) -> torch.Tensor:
    """Copy ``x`` (into ``out``) in whole tiles, ``tiles_per_block`` to a
    block (``direct_geometry``); each thread issues the next tile's 8
    16-byte loads before it stores this tile's."""
    global DIRECT_LAUNCHES
    if tiles_per_block < 0:
        raise ValueError(f"tiles_per_block must be >= 0, got "
                         f"{tiles_per_block}")
    dst = _checked(x, out)
    if x.device.type == "cpu":
        return copy_plain(x, out)
    geo = direct_geometry(_nbytes(x) // ALIGN, sm_count(x.device.index or 0),
                          tiles_per_block)
    check_launch(_library().copy_direct(
        x.data_ptr(), dst.data_ptr(), geo.n16, geo.grid, geo.base, geo.extra,
        current_stream(x.device)), "copy_direct")
    DIRECT_LAUNCHES += 1
    return dst


def ring_fits(n_slots: int, chunk_bytes: int, stores: int = 1,
              blocks_per_sm: int = 1) -> bool:
    """Whether ``copy_bounce`` takes this ring: 2 or 8 slots of a positive
    multiple of 16 bytes under an mbarrier's 2^20, 1 .. n_slots - 1 stores
    left unread, and ``blocks_per_sm`` (1 or 2) rings with their barriers
    in one SM's shared memory."""
    return (n_slots in SLOTS and 1 <= stores < n_slots
            and blocks_per_sm in (1, 2)
            and 0 < chunk_bytes <= _MAX_TX and chunk_bytes % ALIGN == 0
            and RING_OFFSET + n_slots * chunk_bytes
            <= SM_SMEM // blocks_per_sm - 1024)


def copy_bounce(x: torch.Tensor, out: Optional[torch.Tensor] = None,
                n_slots: int = 8, chunk_bytes: Optional[int] = None,
                stores: Optional[int] = None,
                blocks_per_sm: Optional[int] = None,
                dynamic: Optional[bool] = None) -> torch.Tensor:
    """Copy ``x`` (into ``out``) through an ``n_slots``-deep ring of
    ``chunk_bytes`` chunks in shared memory with TMA bulk copies, leaving up
    to ``stores`` stores reading their slots while the others fill, with
    ``blocks_per_sm`` issuing blocks per SM (``Ring`` has the options). An
    option left None takes the depth's ``BOUNCE_DEFAULTS``."""
    given = {"stores": stores, "chunk_bytes": chunk_bytes,
             "blocks_per_sm": blocks_per_sm, "dynamic": dynamic}
    ring = BOUNCE_DEFAULTS.get(n_slots, BOUNCE_DEFAULTS[8])._replace(
        **{k: v for k, v in given.items() if v is not None})
    if not ring_fits(n_slots, ring.chunk_bytes, ring.stores,
                     ring.blocks_per_sm):
        raise ValueError(f"no ring of {n_slots} slots of {ring.chunk_bytes} "
                         f"bytes, {ring.stores} stores unread, "
                         f"{ring.blocks_per_sm} per SM: {SLOTS} slots, "
                         f"1 .. n_slots - 1 stores, chunks a multiple of "
                         f"{ALIGN}, 1 or 2 rings per SM within {SM_SMEM} "
                         f"bytes (1 KB each left to the system)")
    dst = _checked(x, out)
    if x.device.type == "cpu":
        return copy_plain(x, out)
    check_launch(_library().copy_bounce(
        x.data_ptr(), dst.data_ptr(), _nbytes(x), n_slots, ring.stores,
        ring.chunk_bytes, sm_count(x.device.index or 0) * ring.blocks_per_sm,
        _claims(x.device).data_ptr() if ring.dynamic else None,
        current_stream(x.device)), "copy_bounce")
    BOUNCE_LAUNCHES[n_slots] += 1
    return dst
