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

Two watchdogs turn a stall into a named ``PipelineStallError`` instead of
a silent hang (JAX pipeline.py:36-320): the Loader waits on each decode
for at most ``worker_timeout`` seconds (``--worker_timeout``), and
``device_prefetch`` runs each fetch, the upstream iterator and so
``prepare_batch``, in a daemon thread that it waits on for at most
``transfer_timeout`` (``--fetch_timeout``). Both pools are daemon
threads, so a wedged worker can block neither the pool's teardown nor
the interpreter's exit. A value <= 0 or None turns a watchdog off.
"""

from __future__ import annotations

import collections
import contextlib
import concurrent.futures as futures
import functools
import queue as queue_mod
import threading
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from .augment import augment_batch
from .labels import remap_train_ids

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
#: batches ``device_prefetch`` keeps in flight (JAX evaluate.py:199,
#: ``depth=2``)
PREFETCH_DEPTH = 2
#: ``device_prefetch``'s fetch watchdog, in seconds, when the caller names
#: none (``--fetch_timeout``'s default)
FETCH_TIMEOUT = 900.0


class PipelineStallError(RuntimeError):
    """A decode worker or a fetch exceeded its watchdog (JAX
    pipeline.py:36). The message names the stage ('decode worker' or
    'input fetch'), the batch and, for a decode, the dataset index, so a
    bad file or a dead mount is attributable."""


class _DaemonPool:
    """A pool of daemon threads with the ``Future`` interface (JAX
    pipeline.py:46). ``ThreadPoolExecutor``'s workers are joined at exit,
    so a worker wedged past a watchdog would turn the named failure back
    into a hang when the process tries to end; daemon threads do not."""

    def __init__(self, num_workers: int, name: str = "worker"):
        self._q: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        self._stop = False
        self._threads = [threading.Thread(target=self._run,
                                          name=f"{name}-{i}", daemon=True)
                         for i in range(num_workers)]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn, args = item
            if self._stop:
                fut.cancel()
                continue
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # noqa: BLE001 -- relayed by the Future
                fut.set_exception(e)

    def submit(self, fn, *args) -> futures.Future:
        fut: futures.Future = futures.Future()
        self._q.put((fut, fn, args))
        return fut

    def shutdown(self) -> None:
        """Does not wait: pending work is cancelled, a wedged thread is
        left behind (a daemon: it cannot block the interpreter's exit)."""
        self._stop = True
        for _ in self._threads:
            self._q.put(None)


def _timeout(seconds: Optional[float]) -> Optional[float]:
    """A watchdog's timeout; <= 0 or None turns it off (JAX
    pipeline.py:159-162, 266-267)."""
    return seconds if seconds is not None and seconds > 0 else None


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
                  augment_labels: bool = False,
                  rows: Optional[Tuple[int, int]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 NHWC images + uint8 NHW labels -> normalised NCHW images of
    ``dtype`` and int32 labels, on ``device`` (JAX pipeline.py:98-125).
    ``aug_type``: augment on the 0-255 float scale first, with parameters
    drawn by ``generator`` (on ``device``; ``augment.batch_generator``),
    warping the labels too when ``augment_labels``, as the reference
    augments PIL images before ToTensor (GTAV.py:87); ``rows`` = (start,
    global batch) when the batch is a rank's slice of a global batch
    (``augment.augment_batch``). Then
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
                                     augment_labels, rows=rows)
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
    to the card runs asynchronously. ``worker_timeout``: the seconds a
    sample's decode may take before ``PipelineStallError`` names it
    (``--worker_timeout``; <= 0 or None waits for ever).

    ``process_count`` > 1: ``batch_size`` is the global batch, and this
    loader yields rank ``process_id``'s contiguous slice of each, rows
    ``[pid * local, (pid + 1) * local)`` with ``local = batch_size //
    process_count`` (JAX pipeline.py:137-150, 187-191; torch's
    ``DistributedSampler`` in batch form). The batch must divide by the
    count, and a sharded loader must drop the ragged tail, which cannot be
    split evenly.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 num_workers: int = 4, pin_memory: bool = False,
                 worker_timeout: Optional[float] = 120.0,
                 process_id: int = 0, process_count: int = 1):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if batch_size % max(process_count, 1):
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"process_count {process_count}")
        if process_count > 1 and not drop_last:
            raise ValueError("process-sharded loading requires drop_last "
                             "(a ragged tail batch cannot be split evenly "
                             "across processes)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.pin_memory = pin_memory
        self.worker_timeout = _timeout(worker_timeout)
        self.process_id = process_id
        self.process_count = max(process_count, 1)
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
        pool = _DaemonPool(self.num_workers, name="decode")
        pending: collections.deque = collections.deque()

        local = bs // self.process_count
        lo = self.process_id * local

        def submit(b: int) -> None:
            rows = order[b * bs:(b + 1) * bs]
            if self.process_count > 1:
                rows = rows[lo:lo + local]
            pending.append([(pool.submit(self.dataset.__getitem__, int(i)),
                             int(i)) for i in rows])

        def result(b: int, fut: futures.Future, index: int):
            try:
                return fut.result(timeout=self.worker_timeout)
            except futures.TimeoutError:
                raise PipelineStallError(
                    f"decode worker stalled: batch {b}, dataset index "
                    f"{index} not decoded after {self.worker_timeout:g}s "
                    f"(dataset={type(self.dataset).__name__}, "
                    f"num_workers={self.num_workers})") from None

        try:
            for b in range(min(2, n_batches)):
                submit(b)
            for b in range(n_batches):
                if b + 2 < n_batches:
                    submit(b + 2)
                samples = [result(b, f, i) for f, i in pending.popleft()]
                images = torch.from_numpy(np.stack([s[0] for s in samples]))
                labels = torch.from_numpy(np.stack([s[1] for s in samples]))
                if self.pin_memory:
                    images, labels = images.pin_memory(), labels.pin_memory()
                yield images, labels
        finally:
            pool.shutdown()


def device_prefetch(batches: Iterable,
                    transfer_timeout: Optional[float] = FETCH_TIMEOUT,
                    device: Optional[torch.device] = None) -> Iterator:
    """Keep ``PREFETCH_DEPTH`` batches in flight ahead of the consumer (JAX
    pipeline.py:237's double buffering and its fetch watchdog).

    ``batches`` yields prepared batches: ``prepare_batch`` enqueues the
    pinned host-to-device copy and the normalisation on the stream and
    returns at once (no copy of its constants waits for the stream), so
    pulling the next batch before the current step issues its transfer
    before the step's kernels.

    ``transfer_timeout`` (``--fetch_timeout``): each fetch, ``next`` of
    ``batches`` and so the decode wait and ``prepare_batch``, runs in a
    daemon thread, and one that takes longer raises ``PipelineStallError``
    naming the batch; <= 0 or None fetches in the calling thread. The
    watchdog waits on the host thread only, never on the stream. PyTorch's
    current stream is per thread, so the consumer's stream on ``device``
    (a CUDA device), taken when the generator starts, is made current in
    the fetching thread: each batch's copy and normalisation are ordered
    before the step that reads them. A pinned host batch may be freed as
    soon as its copy is enqueued: PyTorch's pinned-memory allocator
    records the copy's stream on the block and reuses it only after the
    copy is done."""
    timeout = _timeout(transfer_timeout)
    it = iter(batches)
    done = object()
    stream = (torch.cuda.current_stream(device)
              if device is not None and torch.device(device).type == "cuda"
              else None)

    def fetch():
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            return next(it, done)

    pool = _DaemonPool(1, name="prefetch") if timeout is not None else None
    count = 0

    def fetch_next():
        nonlocal count
        if pool is None:
            return fetch()
        b, count = count, count + 1
        fut = pool.submit(fetch)
        try:
            return fut.result(timeout=timeout)
        except futures.TimeoutError:
            raise PipelineStallError(
                f"input fetch stalled: batch {b} not produced after "
                f"{timeout:g}s -- covers the host iterator (the decode "
                f"wait) and prepare_batch's host-to-device dispatch"
            ) from None

    try:
        queue = collections.deque()
        for _ in range(PREFETCH_DEPTH):
            batch = fetch_next()
            if batch is done:
                break
            queue.append(batch)
        while queue:
            nxt = queue.popleft()
            batch = fetch_next()
            if batch is not done:
                queue.append(batch)
            yield nxt
    finally:
        if pool is not None:
            pool.shutdown()
