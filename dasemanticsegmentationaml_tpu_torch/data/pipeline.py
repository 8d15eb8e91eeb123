"""Input pipeline: a threaded host loader + batch preparation on the device.

Counterpart of ``dasemanticsegmentationaml_tpu/data/pipeline.py`` for
evaluation: batches ship as uint8 (a quarter of the bytes of normalised
fp32) and are normalised where the model runs. Augmentation and the native
C++ loader are still to be ported (ROADMAP.md).
"""

from __future__ import annotations

import collections
import concurrent.futures as futures
from typing import Iterator, Tuple

import numpy as np
import torch

from .labels import remap_train_ids

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def prepare_batch(images_u8, labels_u8, *, device: torch.device,
                  remap: bool = False, dtype: torch.dtype = torch.float32,
                  memory_format: torch.memory_format = torch.contiguous_format
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 NHWC images + uint8 NHW labels -> normalised NCHW images of
    ``dtype`` and int32 labels, on ``device`` (JAX pipeline.py:98-125,
    without augmentation). ``((u8 / 255) - mean) / std`` runs in fp32, in
    that order; ``remap`` maps raw GTA5 ids to trainIds."""
    images = torch.as_tensor(images_u8).to(device, non_blocking=True)
    labels = torch.as_tensor(labels_u8).to(device, non_blocking=True)
    mean = torch.from_numpy(IMAGENET_MEAN).to(device)
    std = torch.from_numpy(IMAGENET_STD).to(device)
    imgs = (images.float() / 255.0 - mean) / std
    imgs = imgs.permute(0, 3, 1, 2).contiguous(memory_format=memory_format)
    imgs = imgs.to(dtype)
    labels = remap_train_ids(labels) if remap else labels.to(torch.int32)
    return imgs, labels


class Loader:
    """In-order batches of a dataset, decoded by a pool of threads; the
    tail batch is kept (the reference's val loader, train.py:486-491).

    Yields uint8 tensors (images NHWC, labels NHW), in pinned host memory
    when ``pin_memory`` so that the copy to the card runs asynchronously.
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 pin_memory: bool = False):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.pin_memory = pin_memory

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        n, bs = len(self.dataset), self.batch_size
        n_batches = len(self)
        pool = futures.ThreadPoolExecutor(self.num_workers,
                                          thread_name_prefix="decode")
        pending: collections.deque = collections.deque()

        def submit(b: int) -> None:
            pending.append([pool.submit(self.dataset.__getitem__, i)
                            for i in range(b * bs, min(n, (b + 1) * bs))])

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
