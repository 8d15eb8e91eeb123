"""Input pipeline: a threaded host loader + batch preparation on the device.

Counterpart of ``dasemanticsegmentationaml_tpu/data/pipeline.py``:
batches ship as uint8 (a quarter of the bytes of normalised fp32) and are
normalised where the model runs. The train loader shuffles with the JAX
package's order, ``np.random.default_rng((seed, epoch)).permutation(n)``
(JAX pipeline.py:179-184), so both see the same batches. Training
batches of GTA5 are augmented on the device (``augment.py``), or on the
host by a ``host_augment.HostAugment`` dataset. The decode threads run
``data/transforms_host.py`` (the native decoder, or PIL), or read a
``--data_cache`` memmap (``data/cache.py``).
"""

from __future__ import annotations

import collections
import concurrent.futures as futures
import functools
import itertools
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from .augment import augment_batch
from .labels import remap_train_ids

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@functools.lru_cache(maxsize=8)
def normalisation_on(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) as fp32 tensors on ``device``, copied there once.

    A copy from pageable host memory waits for the stream, so copying
    them on every batch would make the host wait for the queued steps.
    Made outside inference mode, as ``ops/resize.py::taps_on`` makes its
    taps, so that evaluation and training share them."""
    with torch.inference_mode(False):
        return (torch.from_numpy(IMAGENET_MEAN).to(device),
                torch.from_numpy(IMAGENET_STD).to(device))


def prepare_batch(images_u8, labels_u8, *, device: torch.device,
                  remap: bool = False, dtype: torch.dtype = torch.float32,
                  memory_format: torch.memory_format = torch.contiguous_format,
                  aug_type: Optional[str] = None,
                  generator: Optional[torch.Generator] = None,
                  augment_labels: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 NHWC images + uint8 NHW labels -> normalised NCHW images of
    ``dtype`` and int32 labels, on ``device`` (JAX pipeline.py:98-125).
    ``aug_type``: augment on the 0-255 float scale first, with parameters
    drawn by ``generator`` (on ``device``; ``augment.batch_generator``),
    warping the labels too when ``augment_labels``, as the reference
    augments PIL images before ToTensor (GTAV.py:87). Then
    ``((x / 255) - mean) / std`` in fp32, in that order, and ``remap``
    maps raw GTA5 ids to trainIds. From pinned host tensors it only
    enqueues work: the constants are cached per device
    (``normalisation_on``, ``labels.py::train_id_lut_on``) and the
    augmentation's parameters are drawn on the device."""
    device = torch.device(device)
    images = torch.as_tensor(images_u8).to(device, non_blocking=True)
    labels = torch.as_tensor(labels_u8).to(device, non_blocking=True)
    mean, std = normalisation_on(device)
    imgs = images.float()
    if aug_type is not None:
        if generator is None:
            raise ValueError("augmentation needs a generator")
        imgs, labels = augment_batch(imgs, labels, aug_type, generator,
                                     augment_labels)
    imgs = (imgs / 255.0 - mean) / std
    imgs = imgs.permute(0, 3, 1, 2).contiguous(memory_format=memory_format)
    imgs = imgs.to(dtype)
    labels = remap_train_ids(labels) if remap else labels.to(torch.int32)
    return imgs, labels


class Loader:
    """Batches of a dataset, decoded by a pool of threads (JAX
    pipeline.py:128-234).

    ``shuffle``: a new order each epoch (``set_epoch``), deterministic in
    (seed, epoch); otherwise in order. ``drop_last``: drop the ragged tail
    batch, as the reference's train loader does (train.py:465-470); the val
    loader keeps it (train.py:486-491). Yields uint8 tensors (images NHWC,
    labels NHW), in pinned host memory when ``pin_memory`` so that the copy
    to the card runs asynchronously.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 num_workers: int = 4, pin_memory: bool = False):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.pin_memory = pin_memory
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Shuffle for ``epoch``, and pass it on to a dataset that keys
        its draws by it (``HostAugment``, through a ``Subset``; JAX
        pipeline.py:171-177)."""
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def order(self) -> np.ndarray:
        """The dataset indices of this epoch, in the order they are
        batched."""
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng((self.seed, self._epoch)).permutation(n)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        order = self.order()
        bs = self.batch_size
        n_batches = len(self)
        pool = futures.ThreadPoolExecutor(self.num_workers,
                                          thread_name_prefix="decode")
        pending: collections.deque = collections.deque()

        def submit(b: int) -> None:
            pending.append([pool.submit(self.dataset.__getitem__, int(i))
                            for i in order[b * bs:(b + 1) * bs]])

        try:
            for b in range(min(2, n_batches)):
                submit(b)
            for b in range(n_batches):
                if b + 2 < n_batches:
                    submit(b + 2)
                samples = [f.result() for f in pending.popleft()]
                images = torch.from_numpy(np.stack([s[0] for s in samples]))
                labels = torch.from_numpy(np.stack([s[1] for s in samples]))
                if self.pin_memory:
                    images, labels = images.pin_memory(), labels.pin_memory()
                yield images, labels
        finally:
            pool.shutdown(wait=True, cancel_futures=True)


def device_prefetch(batches: Iterable) -> Iterator:
    """Keep two batches in flight ahead of the consumer (JAX
    pipeline.py:237's double buffering, without its watchdog thread).

    ``batches`` yields prepared batches: ``prepare_batch`` enqueues the
    pinned host-to-device copy and the normalisation on the stream and
    returns at once (no copy of its constants waits for the stream), so
    pulling the next batch before the current step issues its transfer
    before the step's kernels."""
    it = iter(batches)
    queue = collections.deque(itertools.islice(it, 2))
    while queue:
        batch = queue.popleft()
        queue.extend(itertools.islice(it, 1))
        yield batch
