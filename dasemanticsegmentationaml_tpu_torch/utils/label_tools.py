"""Legacy label and visualisation helpers (reference utils.py:29-254).

A copy of ``dasemanticsegmentationaml_tpu/utils/label_tools.py`` (numpy
and the standard library only; ``pandas`` is imported inside the two
functions that read the CSV, so the module imports without it). It is on
no training or eval path; it keeps the reference's public utils surface:

* ``get_label_info(csv)``          reference utils.py:29-40
* ``one_hot_it / _v11 / _v11_dice`` colour-coded label -> class map
                                    (utils.py:42-96)
* ``reverse_one_hot``              class scores -> argmax class map
                                    (utils.py:98-122; the class axis is
                                    given, numpy arrays or torch tensors)
* ``colour_code_segmentation``     class map -> RGB palette image
                                    (utils.py:125-149)
* ``compute_global_accuracy``      vectorised (utils.py:151-159; ignore
                                    pixels count as wrong)
* ``cal_miou``                     per-class-name mIoU dict (utils.py:243-254)
* ``RandomCrop``                   seeded random crop with padding and
                                    pad_if_needed (utils.py:174-241), on
                                    numpy HWC/HW arrays, torch-RNG-free
"""

from __future__ import annotations

import numbers
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np


def get_label_info(csv_path: str) -> Dict[str, List[int]]:
    """CSV with columns name,r,g,b,class_11 -> {name: [r, g, b, class_11]}."""
    import pandas as pd

    ann = pd.read_csv(csv_path)
    info = {}
    for _, row in ann.iterrows():
        info[row["name"]] = [int(row["r"]), int(row["g"]), int(row["b"]),
                             row["class_11"]]
    return info


def _color_class_map(label: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """(H, W, 3) color label vs (K, 3) palette -> (K, H, W) boolean masks."""
    return np.all(label[None, ...] == colors[:, None, None, :], axis=-1)


def one_hot_it(label: np.ndarray, label_info: Dict) -> np.ndarray:
    """Color-coded (H, W, 3) label -> (H, W) class-index map (utils.py:42-53)."""
    colors = np.array([label_info[k][:3] for k in label_info])
    masks = _color_class_map(label, colors)
    semantic = np.zeros(label.shape[:-1])
    for index in range(colors.shape[0]):
        semantic[masks[index]] = index
    return semantic


def one_hot_it_v11(label: np.ndarray, label_info: Dict) -> np.ndarray:
    """11-class variant: class_11==0 entries collapse to void id 11
    (utils.py:56-76)."""
    semantic = np.zeros(label.shape[:-1])
    class_index = 0
    for key in label_info:
        color = label_info[key][:3]
        mask = np.all(label == np.asarray(color), axis=-1)
        if label_info[key][3] == 1:
            semantic[mask] = class_index
            class_index += 1
        else:
            semantic[mask] = 11
    return semantic


def one_hot_it_v11_dice(label: np.ndarray, label_info: Dict) -> np.ndarray:
    """One-hot (H, W, C+1) with a trailing void channel (utils.py:78-96)."""
    planes = []
    void = np.zeros(label.shape[:2])
    for key in label_info:
        color = label_info[key][:3]
        mask = np.all(label == np.asarray(color), axis=-1)
        if label_info[key][3] == 1:
            planes.append(mask)
        else:
            void[mask] = 1
    planes.append(void)
    return np.stack(planes, axis=-1).astype(np.float32)


def reverse_one_hot(image, class_axis: int = 0):
    """Class scores -> integer class map by argmax (utils.py:98-122; JAX
    label_tools.py:94-109).

    The reference permutes torch CHW to HWC and argmaxes the last axis;
    here the class axis is given (default 0, the torch layout; -1 for
    NHWC). A numpy array gives a numpy array; anything else with an
    ``argmax`` method (a torch tensor) is argmaxed by that method.
    """
    if isinstance(image, np.ndarray):
        return np.argmax(image, axis=class_axis)
    return image.argmax(class_axis)


def colour_code_segmentation(image: np.ndarray, label_values: Dict
                             ) -> np.ndarray:
    """Class map -> RGB using the class_11 palette + black void
    (utils.py:125-149)."""
    palette = [label_values[k][:3] for k in label_values
               if label_values[k][3] == 1]
    palette.append([0, 0, 0])
    colour_codes = np.array(palette)
    return colour_codes[image.astype(int)]


def compute_global_accuracy(pred, label) -> float:
    """Faithful semantics (utils.py:151-159): NO ignore masking, so 255
    labels count as wrong; vectorized instead of a per-pixel python loop."""
    pred = np.asarray(pred).flatten()
    label = np.asarray(label).flatten()
    return float(np.mean(pred == label))


def cal_miou(miou_list: Sequence[float], csv_path: str
             ) -> Tuple[Dict[str, float], float]:
    """Map per-class IoUs onto class_11 names (utils.py:243-254)."""
    import pandas as pd

    ann = pd.read_csv(csv_path)
    miou_dict = {}
    cnt = 0
    for _, row in ann.iterrows():
        if int(row["class_11"]) == 1:
            miou_dict[row["name"]] = miou_list[cnt]
            cnt += 1
    return miou_dict, float(np.mean(miou_list))


class RandomCrop:
    """Seeded random crop of HWC/HW numpy arrays (utils.py:174-241).

    Same parameterization: int or (h, w) size, optional constant padding,
    pad_if_needed. The (i, j) draw uses the stdlib RNG seeded per call like
    the reference (deterministic given the seed), without any torch
    dependency.
    """

    def __init__(self, size, seed: int, padding: int = 0,
                 pad_if_needed: bool = False):
        if isinstance(size, numbers.Number):
            self.size = (int(size), int(size))
        else:
            self.size = tuple(size)
        self.seed = seed
        self.padding = padding
        self.pad_if_needed = pad_if_needed

    @staticmethod
    def get_params(shape_hw: Tuple[int, int], output_size: Tuple[int, int],
                   seed: int) -> Tuple[int, int, int, int]:
        random.seed(seed)
        h, w = shape_hw
        th, tw = output_size
        if w == tw and h == th:
            return 0, 0, h, w
        i = random.randint(0, h - th)
        j = random.randint(0, w - tw)
        return i, j, th, tw

    def _pad(self, img: np.ndarray, left: int, top: int, right: int,
             bottom: int) -> np.ndarray:
        pad_width = [(top, bottom), (left, right)]
        if img.ndim == 3:
            pad_width.append((0, 0))
        return np.pad(img, pad_width, mode="constant")

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.padding > 0:
            p = self.padding
            img = self._pad(img, p, p, p, p)
        if self.pad_if_needed and img.shape[1] < self.size[1]:
            p = int((1 + self.size[1] - img.shape[1]) / 2)
            img = self._pad(img, p, 0, p, 0)
        if self.pad_if_needed and img.shape[0] < self.size[0]:
            p = int((1 + self.size[0] - img.shape[0]) / 2)
            img = self._pad(img, 0, p, 0, p)
        i, j, th, tw = self.get_params(img.shape[:2], self.size, self.seed)
        return img[i:i + th, j:j + tw]
