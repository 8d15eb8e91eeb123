"""Resize ops with PyTorch ``F.interpolate`` semantics, NCHW.

Counterpart of ``dasemanticsegmentationaml_tpu/ops/resize.py``. The JAX
module builds both interpolation flavours from tap matrices because
``jax.image.resize`` has no align_corners mode and a gather is slow on a
TPU (resize.py:58-94); in PyTorch they are native:

* ``resize_bilinear_align_corners`` is ``F.interpolate(mode='bilinear',
  align_corners=True)`` (JAX resize.py:97; reference
  model/model_stages.py:240-242);
* ``upsample_nearest`` is torch ``mode='nearest'`` with the 1x1
  global-context broadcast as ``expand`` (JAX resize.py:129; reference
  model/model_stages.py:123,127,132).

``_align_corners_taps`` is copied verbatim from the JAX module
(resize.py:31-46): the fused kernels (upsample+argmax, upsample+CE) and
their plain versions take their taps from it, so all interpolate with the
same numbers as JAX. ``upsample_two_tap`` is that plain interpolation;
``tap_ranges`` is the kernels' plan of column segments.

``RowWindow`` names a band of output rows of a height-sharded upsample
(``parallel/spatial.py``): the band's taps are the rows of the global
geometry's, rebased to the first logits row the band holds
(``window_taps``), and ``window_rows`` is the logits rows they reach, the
band's rows and its halo.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _align_corners_taps(in_size: int, out_size: int):
    """Per-output-pixel source taps for align_corners=True linear sampling.

    Source position of output pixel o is ``o * (in-1) / (out-1)`` (torch
    aten upsample_bilinear2d with align_corners=True). Returns int32 index
    arrays (lo, hi) and the fp32 weight of the ``hi`` tap.
    """
    if out_size == 1 or in_size == 1:
        lo = np.zeros((out_size,), np.int32)
        return lo, lo, np.zeros((out_size,), np.float32)
    pos = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.floor(pos).astype(np.int32)
    lo = np.minimum(lo, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (pos - lo).astype(np.float32)
    return lo, hi, w_hi


class RowWindow(NamedTuple):
    """Output rows ``[y0, y1)`` of an align_corners upsample of ``h``
    logits rows to ``H`` output rows, computed from a band of logits whose
    first row is the global row ``base``."""
    y0: int
    y1: int
    h: int
    H: int
    base: int


def window_rows(y0: int, y1: int, h: int, H: int) -> Tuple[int, int]:
    """The global logits rows ``[lo, hi)`` that output rows ``[y0, y1)``
    read: the lo tap of the first, to the hi tap of the last. Either may
    lie a row outside the band that owns the output rows."""
    lo, hi, _ = _align_corners_taps(h, H)
    return int(lo[y0]), int(hi[y1 - 1]) + 1


@functools.lru_cache(maxsize=256)
def window_taps(window: RowWindow):
    """(lo, hi, t) of the window's output rows as numpy arrays: the global
    taps of rows ``[y0, y1)``, the indices rebased to ``base``."""
    y0, y1, h, H, base = window
    if not 0 <= y0 < y1 <= H:
        raise ValueError(f"window rows [{y0}, {y1}) outside 0..{H}")
    lo, hi, t = _align_corners_taps(h, H)
    lo, hi = lo[y0:y1] - base, hi[y0:y1] - base
    if lo.min() < 0:
        raise ValueError(f"{window}: the logits band starts below row "
                         f"{base + int(lo.min())}")
    return lo.astype(np.int32), hi.astype(np.int32), t[y0:y1]


def check_window(window: RowWindow, rows: int, out_rows: int) -> None:
    """Raise unless ``rows`` logits rows from ``window.base`` hold every
    tap of the window's ``out_rows`` output rows."""
    if window.y1 - window.y0 != out_rows:
        raise ValueError(f"{window} has {window.y1 - window.y0} output rows,"
                         f" not {out_rows}")
    _, hi, _ = window_taps(window)
    if int(hi.max()) >= rows:
        raise ValueError(f"{window}: the logits band of {rows} rows ends "
                         f"before row {window.base + int(hi.max())}")


@functools.lru_cache(maxsize=64)
def taps_on(in_size: int, out_size: int, device: torch.device,
            window: Optional[RowWindow] = None):
    """(lo, hi, t) of one axis as int32/int32/fp32 tensors on ``device``.

    Made outside inference mode even when first asked for inside it (by
    evaluation): the cached tensors are reused by the training loss,
    whose backward saves them. ``window``: the rebased taps of its rows
    (``window_taps``), cached apart from the full axis's."""
    lo, hi, t = (_align_corners_taps(in_size, out_size) if window is None
                 else window_taps(window))
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device) for a in (lo, hi, t))


def tap_ranges(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, 4) int32: for each source index j, [start, end) of the
    output indices whose ``lo`` tap is j, then of those whose ``hi`` tap is
    j. The taps are monotone, so each set is one contiguous range: the
    fused kernels give the x of the first range to one thread (a column
    segment, whose hi tap is one column)."""
    lo, hi, _ = _align_corners_taps(in_size, out_size)
    j = np.arange(in_size)
    return np.stack([np.searchsorted(lo, j, "left"),
                     np.searchsorted(lo, j, "right"),
                     np.searchsorted(hi, j, "left"),
                     np.searchsorted(hi, j, "right")], 1).astype(np.int32)


@functools.lru_cache(maxsize=64)
def ranges_on(in_size: int, out_size: int, device: torch.device):
    """``tap_ranges`` as an int32 tensor on ``device`` (made outside
    inference mode, as ``taps_on``)."""
    with torch.inference_mode(False):
        return torch.from_numpy(tap_ranges(in_size, out_size)).to(device)


def upsample_two_tap(logits: torch.Tensor, out_hw: Tuple[int, int],
                     window: Optional[RowWindow] = None) -> torch.Tensor:
    """align_corners bilinear upsample of (B, C, h, w) to fp32 (B, C, H, W)
    from ``_align_corners_taps``: rows first, then columns (JAX
    resize.py:109-112), each product and sum its own fp32 op, as the fused
    CUDA kernels compute it (float64 logits stay float64). ``window``:
    only its output rows (``out_hw`` is then the band's), from logits rows
    starting at ``window.base``."""
    x = logits.to(torch.promote_types(logits.dtype, torch.float32))
    _, _, h, w = x.shape
    out_h, out_w = out_hw
    if window is not None:
        check_window(window, h, out_h)
    lo_y, hi_y, ty = taps_on(h, out_h, x.device, window)
    lo_x, hi_x, tx = taps_on(w, out_w, x.device)
    ty = ty.view(out_h, 1)
    rows = (1 - ty) * x.index_select(2, lo_y) + ty * x.index_select(2, hi_y)
    return ((1 - tx) * rows.index_select(3, lo_x)
            + tx * rows.index_select(3, hi_x))


@functools.lru_cache(maxsize=None)
def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Torch 'nearest' source index: floor(o * in / out) (JAX resize.py:50)."""
    idx = np.floor(
        np.arange(out_size, dtype=np.float64) * (in_size / out_size)
    ).astype(np.int64)
    return np.minimum(idx, in_size - 1)


@functools.lru_cache(maxsize=64)
def _nearest_on(in_size: int, out_size: int, device: torch.device):
    """``_nearest_indices`` as an int64 tensor on ``device``, copied there
    once (made outside inference mode, as ``taps_on``): a captured train
    step (``train/supervised.py``) can hold no host-to-device copy."""
    with torch.inference_mode(False):
        return torch.from_numpy(_nearest_indices(in_size, out_size)).to(device)


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NCHW input with align_corners=True."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


def upsample_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest upsample of NCHW input, torch ``mode='nearest'`` rules.

    A 1x1 map (the global-context path) is broadcast with ``expand``;
    integer ratios go to ``F.interpolate``, whose nearest rule is exact
    there; other ratios gather with the float64 indices the JAX module uses
    (resize.py:116-126), so odd input sizes pick the same rows and columns.
    """
    out_h, out_w = out_hw
    in_h, in_w = x.shape[-2:]
    if in_h == 1 and in_w == 1:
        return x.expand(*x.shape[:-2], out_h, out_w)
    if out_h % in_h == 0 and out_w % in_w == 0:
        return F.interpolate(x, size=(out_h, out_w), mode="nearest")
    rows = _nearest_on(in_h, out_h, x.device)
    cols = _nearest_on(in_w, out_w, x.device)
    return x.index_select(-2, rows).index_select(-1, cols)
