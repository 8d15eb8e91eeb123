"""Host-side decode + resize, PIL only.

Counterpart of ``dasemanticsegmentationaml_tpu/data/transforms_host.py``
without its native C++ decoder (a later PR links it). The reference's
DataLoader workers do PIL decode -> ``Image.resize`` (reference
cityscapes.py:61-69, GTAV.py:81-90), with two quirks kept:

* ``self.resize = (height, width)`` reaches ``PIL.Image.resize``, which
  takes ``(width, height)`` (reference cityscapes.py:22,65-66), so with
  ``faithful_resize=True`` (the default) the tensors come out ``width``
  tall and ``height`` wide;
* images resize with PIL BILINEAR, labels with NEAREST.

Outputs are uint8 numpy arrays (HWC image, HW label); normalisation runs
on the device (data/pipeline.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from PIL import Image


def pil_size_for(height: int, width: int, faithful: bool) -> Tuple[int, int]:
    """The (w, h) PIL will actually produce (JAX transforms_host.py:27)."""
    if faithful:
        return (height, width)  # PIL (w, h) = (height_arg, width_arg)
    return (width, height)


def load_image(path: str, out_hw: Optional[Tuple[int, int]] = None,
               faithful_resize: bool = True) -> np.ndarray:
    """Decode an RGB image (reference dataset/utils.py:11-14) and
    bilinear-resize it. Returns uint8 HWC."""
    with open(path, "rb") as f:
        img = Image.open(f).convert("RGB")
        if out_hw is not None:
            img = img.resize(pil_size_for(out_hw[0], out_hw[1],
                                          faithful_resize), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)


def load_label(path: str, out_hw: Optional[Tuple[int, int]] = None,
               faithful_resize: bool = True) -> np.ndarray:
    """Decode a label map and nearest-resize it. Returns uint8 HW; a
    palettised ('P') label keeps its indices."""
    with open(path, "rb") as f:
        img = Image.open(f)
        if img.mode not in ("L", "P", "I"):
            img = img.convert("L")
        if out_hw is not None:
            img = img.resize(pil_size_for(out_hw[0], out_hw[1],
                                          faithful_resize), Image.NEAREST)
        arr = np.asarray(img)
        if arr.ndim == 3:
            arr = arr[..., 0]
        return arr.astype(np.uint8)
