"""Cityscapes/GTA5 label taxonomy and the 34->19 trainId remap.

Counterpart of ``dasemanticsegmentationaml_tpu/data/labels.py``: the same
public Cityscapes label table (the reference reads it from
``dataset/gta5_info.json``, GTAV.py:26-28). The reference remaps with a
36-pass in-place loop (GTAV.py:97-100) and the JAX package with a
compare/select chain, because a gather is slow on a TPU (labels.py:84-100);
here the remap is one gather through the 256-entry LUT.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# (id, name, trainId, color, category, catId, hasInstances, ignoreInEval)
# Standard Cityscapes label definitions (public dataset spec).
CITYSCAPES_LABELS = [
    (0, "unlabeled", 255, (0, 0, 0), "void", 0, False, True),
    (1, "ego vehicle", 255, (0, 0, 0), "void", 0, False, True),
    (2, "rectification border", 255, (0, 0, 0), "void", 0, False, True),
    (3, "out of roi", 255, (0, 0, 0), "void", 0, False, True),
    (4, "static", 255, (0, 0, 0), "void", 0, False, True),
    (5, "dynamic", 255, (111, 74, 0), "void", 0, False, True),
    (6, "ground", 255, (81, 0, 81), "void", 0, False, True),
    (7, "road", 0, (128, 64, 128), "flat", 1, False, False),
    (8, "sidewalk", 1, (244, 35, 232), "flat", 1, False, False),
    (9, "parking", 255, (250, 170, 160), "flat", 1, False, True),
    (10, "rail track", 255, (230, 150, 140), "flat", 1, False, True),
    (11, "building", 2, (70, 70, 70), "construction", 2, False, False),
    (12, "wall", 3, (102, 102, 156), "construction", 2, False, False),
    (13, "fence", 4, (190, 153, 153), "construction", 2, False, False),
    (14, "guard rail", 255, (180, 165, 180), "construction", 2, False, True),
    (15, "bridge", 255, (150, 100, 100), "construction", 2, False, True),
    (16, "tunnel", 255, (150, 120, 90), "construction", 2, False, True),
    (17, "pole", 5, (153, 153, 153), "object", 3, False, False),
    (18, "polegroup", 255, (153, 153, 153), "object", 3, False, True),
    (19, "traffic light", 6, (250, 170, 30), "object", 3, False, False),
    (20, "traffic sign", 7, (220, 220, 0), "object", 3, False, False),
    (21, "vegetation", 8, (107, 142, 35), "nature", 4, False, False),
    (22, "terrain", 9, (152, 251, 152), "nature", 4, False, False),
    (23, "sky", 10, (70, 130, 180), "sky", 5, False, False),
    (24, "person", 11, (220, 20, 60), "human", 6, True, False),
    (25, "rider", 12, (255, 0, 0), "human", 6, True, False),
    (26, "car", 13, (0, 0, 142), "vehicle", 7, True, False),
    (27, "truck", 14, (0, 0, 70), "vehicle", 7, True, False),
    (28, "bus", 15, (0, 60, 100), "vehicle", 7, True, False),
    (29, "caravan", 255, (0, 0, 90), "vehicle", 7, True, True),
    (30, "trailer", 255, (0, 0, 110), "vehicle", 7, True, True),
    (31, "train", 16, (0, 80, 100), "vehicle", 7, True, False),
    (32, "motorcycle", 17, (0, 0, 230), "vehicle", 7, True, False),
    (33, "bicycle", 18, (119, 11, 32), "vehicle", 7, True, False),
    (34, "unknown", 255, (0, 0, 0), "void", 0, False, True),  # GTA5 extra
    (-1, "license plate", 255, (0, 0, 142), "vehicle", 7, False, True),
]

NUM_TRAIN_CLASSES = 19
IGNORE_LABEL = 255


@functools.lru_cache(maxsize=None)
def train_id_lut() -> np.ndarray:
    """256-entry uint8 LUT: raw uint8 label id -> trainId (255 = ignore)
    (JAX labels.py:75)."""
    lut = np.full(256, IGNORE_LABEL, dtype=np.uint8)
    for lid, _name, tid, *_rest in CITYSCAPES_LABELS:
        if 0 <= lid < 256:
            lut[lid] = tid
    lut.setflags(write=False)
    return lut


@functools.lru_cache(maxsize=8)
def train_id_lut_on(device: torch.device) -> torch.Tensor:
    """``train_id_lut`` as int32 on ``device``, copied there once (a copy
    per batch would wait for the stream), outside inference mode."""
    with torch.inference_mode(False):
        return torch.from_numpy(train_id_lut().astype(np.int32)).to(device)


def remap_train_ids(labels: torch.Tensor) -> torch.Tensor:
    """Raw uint8 ids -> int32 trainIds, one gather on ``labels``' device."""
    return train_id_lut_on(labels.device)[labels.long()]


def train_id_colors() -> np.ndarray:
    """(20, 3) uint8 palette for trainIds 0..18 and the ignore label
    (black, index 19) (JAX labels.py:103)."""
    colors = np.zeros((NUM_TRAIN_CLASSES + 1, 3), dtype=np.uint8)
    for _lid, _name, tid, color, *_rest in CITYSCAPES_LABELS:
        if tid != IGNORE_LABEL:
            colors[tid] = color
    return colors
