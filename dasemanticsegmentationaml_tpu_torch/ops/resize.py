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
same numbers as JAX. ``upsample_two_tap`` is that plain interpolation.
"""

from __future__ import annotations

import functools
from typing import Tuple

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


@functools.lru_cache(maxsize=64)
def taps_on(in_size: int, out_size: int, device: torch.device):
    """(lo, hi, t) of one axis as int32/int32/fp32 tensors on ``device``.

    Made outside inference mode even when first asked for inside it (by
    evaluation): the cached tensors are reused by the training loss,
    whose backward saves them."""
    lo, hi, t = _align_corners_taps(in_size, out_size)
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device) for a in (lo, hi, t))


def upsample_two_tap(logits: torch.Tensor,
                     out_hw: Tuple[int, int]) -> torch.Tensor:
    """align_corners bilinear upsample of (B, C, h, w) to fp32 (B, C, H, W)
    from ``_align_corners_taps``: rows first, then columns (JAX
    resize.py:109-112), each product and sum its own fp32 op, as the fused
    CUDA kernels compute it."""
    x = logits.float()
    _, _, h, w = x.shape
    out_h, out_w = out_hw
    lo_y, hi_y, ty = taps_on(h, out_h, x.device)
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
    rows = torch.from_numpy(_nearest_indices(in_h, out_h)).to(x.device)
    cols = torch.from_numpy(_nearest_indices(in_w, out_w)).to(x.device)
    return x.index_select(-2, rows).index_select(-1, cols)
