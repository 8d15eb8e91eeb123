"""Dataset index scanners + sample loading.

Counterpart of ``dasemanticsegmentationaml_tpu/data/datasets.py``, with
the reference's file-discovery and pairing rules unchanged:

* ``CityScapes``: ``<root>/images/<mode>/<city>/*`` and
  ``<root>/gtFine/<mode>/<city>/*`` (names containing 'color' skipped),
  paired by independent sorted order (reference cityscapes.py:38-59);
* ``GtaV``: flat ``<root>/images`` + ``<root>/labels`` sorted pairing
  (reference GTAV.py:65-79); raw GTA ids are remapped to trainIds on the
  device (data/labels.py);
* ``train_val_split``: sklearn's 75/25 ``train_test_split(random_state=42,
  shuffle=True)`` (reference train.py:458) without sklearn.

Samples are uint8 numpy arrays (image HWC, label HW).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .transforms_host import load_image, load_label

_IMG_EXTS = (".png", ".jpg", ".jpeg")


class _PairDataset:
    """List of (image_path, label_path) + resize config."""

    def __init__(self, pairs, height: int, width: int,
                 faithful_resize: bool = True):
        self.pairs: List[Tuple[str, str]] = list(pairs)
        self.height = height
        self.width = width
        self.faithful_resize = faithful_resize

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        image_path, label_path = self.pairs[idx]
        hw = (self.height, self.width)
        return (load_image(image_path, hw, self.faithful_resize),
                load_label(label_path, hw, self.faithful_resize))

    @property
    def needs_remap(self) -> bool:
        """Whether the labels hold raw ids to map to trainIds (a field of
        the ``--data_cache`` fingerprint, JAX datasets.py:55-57)."""
        return False


class CityScapes(_PairDataset):
    """reference cityscapes.py:12-74; labels are trainId-encoded already."""

    def __init__(self, mode: str, root: str, height: int, width: int,
                 faithful_resize: bool = True):
        root = os.path.normpath(root)
        image_dir = os.path.join(root, "images", mode)
        label_dir = os.path.join(root, "gtFine", mode)
        for d in (image_dir, label_dir):
            if not os.path.isdir(d):
                raise FileNotFoundError(
                    f"CityScapes {mode}: expected directory {d!r} "
                    "(layout: <root>/images/<mode>/<city>/*.png + "
                    "<root>/gtFine/<mode>/<city>/*labelTrainIds.png)")

        def scan(top: str, skip_color: bool) -> List[str]:
            found = []
            for city in sorted(os.listdir(top)):
                folder = os.path.join(top, city)
                if not os.path.isdir(folder):
                    continue
                for filename in os.listdir(folder):
                    name = filename.lower()
                    if name.endswith(_IMG_EXTS) and not (
                            skip_color and "color" in name):
                        found.append(os.path.join(folder, filename))
            return found

        images = scan(image_dir, skip_color=False)
        labels = scan(label_dir, skip_color=True)
        if len(images) != len(labels):
            raise ValueError(f"CityScapes {mode}: {len(images)} images vs "
                             f"{len(labels)} labels")
        super().__init__(zip(sorted(images), sorted(labels)), height, width,
                         faithful_resize)


class GtaV(_PairDataset):
    """reference GTAV.py:13-100. ``aug_type`` names the augmentation menu
    of its training batches (None | CS-HF | H-RP | B-GS-R), which
    ``pipeline.prepare_batch`` applies on the device, or
    ``host_augment.HostAugment`` on the host (JAX datasets.py:106-129)."""

    def __init__(self, root: str, aug_type: Optional[str], height: int,
                 width: int, faithful_resize: bool = True):
        root = os.path.normpath(root)
        image_dir = os.path.join(root, "images")
        label_dir = os.path.join(root, "labels")
        for d in (image_dir, label_dir):
            if not os.path.isdir(d):
                raise FileNotFoundError(
                    f"GtaV: expected directory {d!r} "
                    "(layout: <root>/images/*.png + <root>/labels/*.png)")
        images = sorted(os.path.join(image_dir, f)
                        for f in os.listdir(image_dir))
        labels = sorted(os.path.join(label_dir, f)
                        for f in os.listdir(label_dir))
        if len(images) != len(labels):
            raise ValueError(
                f"GtaV: {len(images)} images vs {len(labels)} labels")
        super().__init__(zip(images, labels), height, width, faithful_resize)
        if aug_type not in (None, "CS-HF", "H-RP", "B-GS-R"):
            raise KeyError(aug_type)
        self.aug_type = aug_type

    @property
    def needs_remap(self) -> bool:
        return True


class Subset:
    """View over a dataset by index list (reference train.py:462-463)."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx: int):
        return self.dataset[self.indices[idx]]

    def __getattr__(self, name):
        """The wrapped dataset's attributes (``set_epoch``, ``aug_type``),
        as the JAX Subset forwards them."""
        return getattr(self.dataset, name)


def train_val_split(n: int, train_size: float = 0.75, seed: int = 42):
    """sklearn's ``train_test_split(range(n), train_size=0.75,
    random_state=42, shuffle=True)`` (reference train.py:458; JAX
    datasets.py:154): test = the first ``ceil((1-train_size)*n)`` of
    ``RandomState(seed).permutation(n)``, train = the next
    ``floor(train_size*n)``."""
    perm = np.random.RandomState(seed).permutation(n)
    n_test = int(math.ceil((1.0 - train_size) * n))
    n_train = int(math.floor(train_size * n))
    return ([int(i) for i in perm[n_test:n_test + n_train]],
            [int(i) for i in perm[:n_test]])
