"""Packed decoded-sample cache (``--data_cache``): decode once, memmap every
epoch after.

A copy of ``dasemanticsegmentationaml_tpu/data/cache.py`` (numpy only),
single-process: ``dataset_fingerprint`` :57, ``CachedDataset`` :97,
``build_cache`` :140 and ``open_or_build`` :222 (without its multi-process
wait for rank 0's publication). The reference re-decodes and re-resizes
every PNG in every epoch inside its DataLoader workers (reference
train.py:465-491, cityscapes.py:61-69, GTAV.py:80-96); epoch 2 onwards
repeats that work on identical bytes.

This module runs the decode + resize once per (dataset contents, resize
config) and stores the results in two uint8 memmaps::

    <cache_root>/<fingerprint16>/images.u8   (N, H, W, 3) C-order
    <cache_root>/<fingerprint16>/labels.u8   (N, H, W)
    <cache_root>/<fingerprint16>/manifest.json

``CachedDataset`` serves ``__getitem__`` as a memory read with the scan
datasets' interface (uint8 HWC image, uint8 HW label, ``needs_remap``,
``aug_type``), so the Loader, ``prepare_batch`` and the augmentation are
untouched; its samples are byte-identical to the decode path's
(tests/test_torch_cache.py).

Staleness: the fingerprint hashes the dataset type, the resize config and
every (path, size, mtime_ns) pair, folding in each ``Subset`` level's
indices, so an edit, an addition or a reordering names another cache
directory and the stale one is simply unused. ``_VERSION`` and the
fingerprint's fields are the JAX package's, and the port's ``CityScapes``
and ``GtaV`` carry the JAX class names, so both packages name one tree's
cache alike and read each other's. Publication is atomic: the cache is
built into a temporary directory and renamed into place.
"""

from __future__ import annotations

import hashlib
import concurrent.futures as futures
import json
import os
import shutil
import socket
import time
import uuid
from typing import Optional, Tuple

import numpy as np

_MANIFEST = "manifest.json"
_IMAGES = "images.u8"
_LABELS = "labels.u8"
# v2: native loader's NEAREST resize switched to Pillow's cumulative-
# addition index math (bit-exact parity fix) — caches built by v1 can
# hold labels off by one source row/column at some geometries
_VERSION = 2


def dataset_fingerprint(dataset) -> str:
    """Content hash of a pair-scan dataset (CityScapes / GtaV / any
    object with ``.pairs`` of (image_path, label_path)).

    Hashes dataset type, resize config, and per-file (path, size,
    mtime_ns) stats — NOT file bytes, so fingerprinting a 25k-image
    dataset is a metadata walk, not a read.
    """
    h = hashlib.sha256()
    # Subset forwards attribute reads to its base dataset (__getattr__),
    # so a plain .pairs read would silently fingerprint the FULL dataset
    # for any subset of it; unwrap explicitly, folding the index view
    # into the hash at each level.
    while "indices" in vars(dataset) and "dataset" in vars(dataset):
        # int() each index: Subset callers routinely pass numpy arrays /
        # np.int64 lists, which json.dumps rejects with a TypeError
        h.update(json.dumps(
            {"subset": [int(i) for i in vars(dataset)["indices"]]}
        ).encode())
        dataset = vars(dataset)["dataset"]
    pairs = getattr(dataset, "pairs", None)
    if pairs is None:
        raise TypeError(
            f"{type(dataset).__name__} has no .pairs — the packed cache "
            "only wraps path-scan datasets (CityScapes/GtaV)")
    h.update(json.dumps({
        "version": _VERSION,
        "type": type(dataset).__name__,
        "height": dataset.height,
        "width": dataset.width,
        "faithful_resize": bool(dataset.faithful_resize),
        "needs_remap": bool(dataset.needs_remap),
    }, sort_keys=True).encode())
    for image_path, label_path in pairs:
        for p in (image_path, label_path):
            st = os.stat(p)
            h.update(f"{p}\0{st.st_size}\0{st.st_mtime_ns}\0".encode())
    return h.hexdigest()


class CachedDataset:
    """Memmap-backed view over a built cache directory.

    Same sample contract as the scan datasets (data/datasets.py): uint8
    HWC image, uint8 HW label. ``aug_type`` is carried from the wrapped
    dataset at open time (it parameterizes the on-device pipeline, not
    the cached bytes).
    """

    def __init__(self, cache_dir: str, aug_type: Optional[str] = None):
        with open(os.path.join(cache_dir, _MANIFEST)) as f:
            man = json.load(f)
        if man.get("version") != _VERSION:
            raise ValueError(f"cache version {man.get('version')} != "
                             f"{_VERSION} at {cache_dir}")
        self._man = man
        self.cache_dir = cache_dir
        n, h, w = man["length"], man["sample_height"], man["sample_width"]
        self._images = np.memmap(os.path.join(cache_dir, _IMAGES),
                                 dtype=np.uint8, mode="r",
                                 shape=(n, h, w, 3))
        self._labels = np.memmap(os.path.join(cache_dir, _LABELS),
                                 dtype=np.uint8, mode="r",
                                 shape=(n, h, w))
        self._needs_remap = bool(man["needs_remap"])
        self.aug_type = aug_type
        self.height = man["height"]
        self.width = man["width"]
        self.faithful_resize = bool(man["faithful_resize"])

    def __len__(self) -> int:
        return self._man["length"]

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        # np.array copies: the page-cache read happens HERE, in the
        # Loader's worker thread, not later under np.stack
        return np.array(self._images[idx]), np.array(self._labels[idx])

    @property
    def needs_remap(self) -> bool:
        return self._needs_remap


def build_cache(dataset, cache_dir: str, num_workers: int = 4) -> str:
    """Decode every sample of ``dataset`` into ``cache_dir`` (atomic).

    Returns ``cache_dir``. Safe when several processes build it at once:
    each writes a private tmp dir and the first ``os.rename`` wins.
    """
    parent = os.path.dirname(os.path.abspath(cache_dir)) or "."
    os.makedirs(parent, exist_ok=True)
    # hostname + pid + random: pid alone COLLIDES across hosts sharing the
    # cache FS (containerized ranks are routinely all pid 1), making two
    # processes write the same tmp memmaps concurrently
    tmp = (f"{cache_dir}.tmp-{socket.gethostname()}-{os.getpid()}-"
           f"{uuid.uuid4().hex[:8]}")
    os.makedirs(tmp)
    try:
        n = len(dataset)
        if n == 0:
            raise ValueError("refusing to cache an empty dataset")
        img0, lab0 = dataset[0]
        h, w = img0.shape[:2]
        if img0.shape != (h, w, 3) or img0.dtype != np.uint8:
            raise ValueError(f"unexpected image sample {img0.shape} "
                             f"{img0.dtype}")
        if lab0.shape != (h, w) or lab0.dtype != np.uint8:
            raise ValueError(f"unexpected label sample {lab0.shape} "
                             f"{lab0.dtype}")
        images = np.memmap(os.path.join(tmp, _IMAGES), dtype=np.uint8,
                           mode="w+", shape=(n, h, w, 3))
        labels = np.memmap(os.path.join(tmp, _LABELS), dtype=np.uint8,
                           mode="w+", shape=(n, h, w))

        def put(i):
            img, lab = dataset[i] if i else (img0, lab0)
            images[i] = img
            labels[i] = lab

        with futures.ThreadPoolExecutor(
                max(1, num_workers), thread_name_prefix="cache-build") as pool:
            for job in [pool.submit(put, i) for i in range(n)]:
                job.result()
        images.flush()
        labels.flush()
        del images, labels
        manifest = {
            "version": _VERSION,
            "fingerprint": dataset_fingerprint(dataset),
            "length": n,
            "sample_height": h,
            "sample_width": w,
            "height": dataset.height,
            "width": dataset.width,
            "faithful_resize": bool(dataset.faithful_resize),
            "needs_remap": bool(dataset.needs_remap),
            "type": type(dataset).__name__,
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        try:
            os.rename(tmp, cache_dir)
        except OSError:
            if not os.path.exists(os.path.join(cache_dir, _MANIFEST)):
                raise  # a real failure, not a lost publication race
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    return cache_dir


def open_or_build(dataset, cache_root: str, num_workers: int = 4,
                  process_id: int = 0,
                  wait_for_publish: float = 0.0) -> CachedDataset:
    """The one-call entry: a CachedDataset for ``dataset``, building the
    cache if this exact content and config is not cached yet.

    Each distinct (dataset contents, resize config) gets its own
    subdirectory of ``cache_root`` keyed by fingerprint, so one
    ``--data_cache`` directory serves the source, target and val datasets
    and survives dataset edits (stale entries are never opened again).

    ``wait_for_publish`` > 0 (a rank of a data-parallel run): a rank above
    0 polls for rank 0's published manifest for up to that many seconds
    instead of decoding the whole dataset into a build that loses the
    rename race, and builds its own copy only if the wait runs out (JAX
    cache.py:222-250).
    """
    fp = dataset_fingerprint(dataset)
    cache_dir = os.path.join(cache_root, fp[:16])
    manifest = os.path.join(cache_dir, _MANIFEST)
    if not os.path.exists(manifest):
        if process_id > 0 and wait_for_publish > 0:
            deadline = time.monotonic() + wait_for_publish
            while (not os.path.exists(manifest)
                   and time.monotonic() < deadline):
                time.sleep(0.5)
        if not os.path.exists(manifest):
            build_cache(dataset, cache_dir, num_workers=num_workers)
    cached = CachedDataset(cache_dir,
                           aug_type=getattr(dataset, "aug_type", None))
    if cached._man["fingerprint"] != fp:  # pragma: no cover - paranoia
        raise RuntimeError(f"cache dir {cache_dir} holds a different "
                           "fingerprint; delete it and rerun")
    return cached
