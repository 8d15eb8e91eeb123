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
(resize.py:31-46): the fused upsample+argmax kernel and its plain version
take their taps from it, so both interpolate with the same numbers as JAX.
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
