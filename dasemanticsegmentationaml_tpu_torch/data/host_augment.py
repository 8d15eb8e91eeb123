"""Host-side augmentation (``--host_augment True``).

Counterpart of ``dasemanticsegmentationaml_tpu/data/host_augment.py``
(``rng_for`` :49, ``perspective_coeffs`` :56,
``sample_perspective_endpoints`` :72, ``sample_params`` :90,
``warp_nearest_label`` :118, ``apply_family_label`` :133, ``HostAugment``
:150). The reference runs every augmentation menu on the host, inside its
DataLoader workers (reference dataset/GTAV.py:32-59, train.py:465-470);
``HostAugment`` restores that shape: a dataset wrapper whose menu runs in
the Loader's decode threads, through the native C++ ops
(``native_augment``). The numpy functions here and in
``augment_pil_exact`` are their plain version, which the tests hold them
against.

Determinism: each sample draws its parameters from a fresh
``np.random.Generator`` keyed by ``(seed, epoch, idx)``, as the JAX
package does, so the port's host path draws exactly the JAX package's
augmentation and the two are compared bit for bit
(tests/test_torch_host_augment.py). The distributions are torchvision's
(RandomApply p=0.5; ColorJitter uniform ranges; RandomPerspective
integer corners with its float64 least squares cast to float32;
RandomRotation uniform angle); the stream is numpy's, not torch's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import augment_pil_exact as ape
from . import native_augment

IGNORE_FILL = 255
AUG_TYPES = ("CS-HF", "H-RP", "B-GS-R")


def rng_for(seed: int, epoch: int, idx: int) -> np.random.Generator:
    """Per-sample generator keyed (seed, epoch, idx): the same draw
    whatever thread or run decodes the sample."""
    return np.random.default_rng(
        np.random.SeedSequence((int(seed), int(epoch), int(idx))))


def perspective_coeffs(startpoints, endpoints):
    """torchvision ``_get_perspective_coeffs``: the 8 homography
    coefficients mapping OUTPUT (endpoint) space back to INPUT
    (startpoint) space, by float64 least squares cast to float32, the
    dtype path torchvision feeds PIL."""
    a = np.zeros((8, 8), np.float64)
    for i, (p1, p2) in enumerate(zip(endpoints, startpoints)):
        a[2 * i] = [p1[0], p1[1], 1, 0, 0, 0,
                    -p2[0] * p1[0], -p2[0] * p1[1]]
        a[2 * i + 1] = [0, 0, 0, p1[0], p1[1], 1,
                        -p2[1] * p1[0], -p2[1] * p1[1]]
    b = np.asarray(startpoints, np.float64).reshape(8)
    res, *_ = np.linalg.lstsq(a, b, rcond=None)
    return [float(np.float32(v)) for v in res]


def sample_perspective_endpoints(rng: np.random.Generator, h: int, w: int,
                                 distortion: float = 0.5):
    """torchvision RandomPerspective.get_params' integer corners."""
    half_h, half_w = h // 2, w // 2
    dh = int(distortion * half_h)
    dw = int(distortion * half_w)
    ri = lambda lo, hi: int(rng.integers(lo, hi))  # noqa: E731
    topleft = (ri(0, dw + 1), ri(0, dh + 1))
    topright = (ri(w - dw - 1, w), ri(0, dh + 1))
    botright = (ri(w - dw - 1, w), ri(h - dh - 1, h))
    botleft = (ri(0, dw + 1), ri(h - dh - 1, h))
    startpoints = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
    endpoints = [topleft, topright, botright, botleft]
    return startpoints, endpoints


def sample_params(aug_type: str, rng: np.random.Generator, h: int, w: int,
                  apply_prob: float = 0.5) -> dict:
    """One sample's realization of a reference menu (dataset/GTAV.py:42-46
    wrapped in RandomApply(p=0.5), :51), in the schema that
    ``augment_pil_exact.apply_family``, ``apply_family_label``,
    ``native_augment`` and ``augment.apply_family_with_params`` share."""
    params = {"applied": bool(rng.random() < apply_prob)}
    if not params["applied"]:
        return params
    if aug_type == "CS-HF":
        params["contrast"] = float(rng.uniform(2.0, 5.0))
        params["saturation"] = float(rng.uniform(1.0, 3.0))
    elif aug_type == "H-RP":
        params["hue"] = float(rng.uniform(-0.2, 0.2))
        start, end = sample_perspective_endpoints(rng, h, w, 0.5)
        params["startpoints"], params["endpoints"] = start, end
        params["coeffs"] = perspective_coeffs(start, end)
    elif aug_type == "B-GS-R":
        params["brightness"] = float(rng.uniform(1.0, 2.0))
        params["angle"] = float(rng.uniform(-90.0, 90.0))
    else:
        raise ValueError(f"unknown aug_type {aug_type!r}")
    return params


def warp_nearest_label(label: np.ndarray, coeffs,
                       fill: int = IGNORE_FILL) -> np.ndarray:
    """NEAREST perspective warp of an HW label map on the image's float64
    source grid (``augment_pil_exact.perspective_source_grid``): index
    floor(s + 0.5), the shared half-open mask, ignore-fill outside."""
    h, w = label.shape
    sx, sy, oob = ape.perspective_source_grid(h, w, coeffs)
    xi = np.clip(np.floor(sx + 0.5).astype(np.int64), 0, w - 1)
    yi = np.clip(np.floor(sy + 0.5).astype(np.int64), 0, h - 1)
    out = label[yi, xi].copy()
    out[oob] = fill
    return out


def apply_family_label(label: np.ndarray, aug_type: str, params: dict,
                       fill: int = IGNORE_FILL) -> np.ndarray:
    """A menu's GEOMETRIC ops mirrored onto the label (nearest, ignore
    fill): ``--augment_labels``. The reference leaves labels untransformed
    (dataset/GTAV.py:87-89; SURVEY.md section 4 bug 5), which
    ``--augment_labels False`` keeps."""
    if not params.get("applied", True):
        return label.copy()
    if aug_type == "CS-HF":
        return label[:, ::-1].copy()
    if aug_type == "H-RP":
        return warp_nearest_label(label, params["coeffs"], fill)
    if aug_type == "B-GS-R":
        return ape.rotate_nearest(label, params["angle"], fill=fill)
    raise ValueError(f"unknown aug_type {aug_type!r}")


class HostAugment:
    """Dataset wrapper: one reference menu on the host, in the Loader's
    decode threads, through the native ops (the reference's deployment
    shape, dataset/GTAV.py:87 + train.py:465-470). ``set_epoch`` re-keys
    the per-sample draws; ``Loader.set_epoch`` forwards here."""

    def __init__(self, dataset, aug_type: str, seed: int = 0,
                 augment_labels: bool = False, apply_prob: float = 0.5):
        if aug_type not in AUG_TYPES:
            raise KeyError(aug_type)
        self.dataset = dataset
        self.host_aug_type = aug_type
        self.seed = seed
        self.augment_labels = augment_labels
        self.apply_prob = apply_prob
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int):
        img, label = self.dataset[idx]
        params = sample_params(self.host_aug_type,
                               rng_for(self.seed, self._epoch, idx),
                               img.shape[0], img.shape[1], self.apply_prob)
        img = native_augment.apply_family(img, self.host_aug_type, params)
        if self.augment_labels:
            label = native_augment.apply_family_label(
                np.asarray(label), self.host_aug_type, params, IGNORE_FILL)
        return img, label

    @property
    def aug_type(self) -> Optional[str]:
        """What the device should still apply: nothing, the menu ran
        here."""
        return None

    def __getattr__(self, name):
        return getattr(self.dataset, name)
