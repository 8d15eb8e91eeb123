"""Host-side decode + resize.

Counterpart of ``dasemanticsegmentationaml_tpu/data/transforms_host.py``.
The reference's DataLoader workers do PIL decode -> ``Image.resize``
(reference cityscapes.py:61-69, GTAV.py:81-90), with two quirks kept:

* ``self.resize = (height, width)`` reaches ``PIL.Image.resize``, which
  takes ``(width, height)`` (reference cityscapes.py:22,65-66), so with
  ``faithful_resize=True`` (the default) the tensors come out ``width``
  tall and ``height`` wide;
* images resize with PIL BILINEAR, labels with NEAREST.

Decode prefers the native C++ library (``data/native.py``, the port's
build of ``native/loader.cpp``), which gives PIL's bytes, and decodes with
PIL when it returns None: the library could not be built on this machine
(the CLI prints why) or declines the file (JAX transforms_host.py:41-84).
Outputs are uint8 numpy arrays (HWC image, HW label); normalisation runs
on the device (data/pipeline.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from PIL import Image

from . import native


def pil_size_for(height: int, width: int, faithful: bool) -> Tuple[int, int]:
    """The (w, h) PIL will actually produce (JAX transforms_host.py:27)."""
    if faithful:
        return (height, width)  # PIL (w, h) = (height_arg, width_arg)
    return (width, height)


def load_image(path: str, out_hw: Optional[Tuple[int, int]] = None,
               faithful_resize: bool = True) -> np.ndarray:
    """Decode an RGB image (reference dataset/utils.py:11-14) and
    bilinear-resize it. Returns uint8 HWC."""
    size = (None if out_hw is None
            else pil_size_for(out_hw[0], out_hw[1], faithful_resize))
    arr = native.decode_resize(path, size, "bilinear")
    if arr is not None:
        return arr
    with open(path, "rb") as f:
        img = Image.open(f).convert("RGB")
        if size is not None:
            img = img.resize(size, Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)


def load_label(path: str, out_hw: Optional[Tuple[int, int]] = None,
               faithful_resize: bool = True) -> np.ndarray:
    """Decode a label map and nearest-resize it. Returns uint8 HW; a
    palettised ('P') label keeps its indices."""
    size = (None if out_hw is None
            else pil_size_for(out_hw[0], out_hw[1], faithful_resize))
    arr = native.decode_resize(path, size, "nearest", grayscale=True)
    if arr is not None:
        return arr
    with open(path, "rb") as f:
        img = Image.open(f)
        if img.mode not in ("L", "P", "I"):
            img = img.convert("L")
        if size is not None:
            img = img.resize(size, Image.NEAREST)
        arr = np.asarray(img)
        if arr.ndim == 3:
            arr = arr[..., 0]
        return arr.astype(np.uint8)
