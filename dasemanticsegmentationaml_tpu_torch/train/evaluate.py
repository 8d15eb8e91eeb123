"""Evaluation (reference train.py:24-61 ``val``) on the device.

Counterpart of ``dasemanticsegmentationaml_tpu/train/evaluate.py``. Per
batch: ``features`` -> the fused upsample+argmax kernel -> int32
predictions -> the confusion matrix and the correct-pixel count, all
accumulated as int64 on the device (``eval_counts``) and read back once at
the end. Batches are prepared two ahead of the model through
``data/pipeline.py::device_prefetch`` (JAX evaluate.py:199), whose fetch
watchdog (``fetch_timeout``) names a stalled batch. IoU is computed on
the host in float64 by ``ops/metrics.py::per_class_iou`` (JAX
evaluate.py:246-257; reference utils.py:170-172). The JAX module's fp32
flush windows exist for a TPU's integer-exact range; int64 counters need
none.

``scan_window`` K > 1 is JAX's ``make_eval_scan_step`` (evaluate.py:95-126,
used :165-167 and :217-230): K same-shaped batches go to the device in
one dispatch. JAX walks them with ``lax.scan`` to save a TPU's round
trips; on a card the same cost is the host's launch of each batch's
kernels (the eval forward is host-bound: PERF.md §5), so the port
captures the step (forward, upsample+argmax, confusion-matrix
``index_add_``, correct count) for K batches once per batch shape into a
``torch.cuda.CUDAGraph`` over K static input slots, and one replay walks a
window. The captured graph reads the model's parameters and BN statistics
where they live, so a validation after optimizer steps sees the new
weights; the caller keeps them between evaluations (``EvalGraphs``), and
they are captured again when a parameter or buffer has moved
(``model.to`` reallocates). Batches of another shape (the
``drop_last=False`` tail) and the leftovers of the last window take the
eager step, as in JAX :217-240. On the CPU there is no graph: every
batch takes the eager step, whose integer counts are the window's
exactly. On a card a capture that fails raises; it never falls back to
eager.

Faithful metric semantics:
* mIoU drops pixels labelled outside [0, C) (reference utils.py:161-167);
* 'precision' counts ignore pixels as wrong (utils.py:151-159), averaged
  per image (train.py:52-54), which at a fixed image size is the pixel
  mean accumulated here.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..data.pipeline import FETCH_TIMEOUT, device_prefetch
from ..ops.cuda import int8_conv as _int8_conv
from ..ops.cuda import upsample_argmax as _upsample_argmax
from ..ops.cuda.upsample_argmax import upsample_argmax
from ..ops.metrics import confusion_matrix, per_class_iou
from ..parallel.distributed import allreduce_counts

#: the kernel launch counters a captured graph holds launches of
_COUNTERS = {"upsample_argmax": _upsample_argmax, "int8_conv": _int8_conv}
#: launches enqueued by graph replays in this process, by kernel: a
#: replay does not pass through a wrapper, so its counter does not move;
#: each replay adds here what the wrapper counted while it was captured
REPLAYED_LAUNCHES: Dict[str, int] = {name: 0 for name in _COUNTERS}
#: wrapper calls made while a graph was captured, by kernel: they recorded
#: launches into the graph and launched nothing, so a run's launches are
#: its counter's rise, less these, plus ``REPLAYED_LAUNCHES``
CAPTURED_LAUNCHES: Dict[str, int] = {name: 0 for name in _COUNTERS}
#: graph replays and captures in this process
GRAPH_REPLAYS = 0
GRAPH_CAPTURES = 0


def predict(model, images: torch.Tensor, use_fused_kernel: bool,
            amp_dtype: Optional[torch.dtype] = None,
            spatial=None) -> torch.Tensor:
    """NCHW images -> (B, H, W) int32 trainIds (JAX evaluate.py:38-46).

    use_fused_kernel: the main head's stride-8 logits go through
    ``upsample_argmax`` (the CUDA kernel on a CUDA tensor); otherwise the
    full forward upsamples all three heads and argmax picks from the main
    one. amp_dtype: run the model under ``torch.autocast`` in that dtype
    (bf16), with BN kept in fp32. Autocast's weight-cast cache is off: a
    captured graph must cast the live weights on every replay (a cached
    cast would replay a stale copy), and a forward uses each weight once.
    ``spatial``: ``images`` is this rank's band, the model (converted by
    ``parallel/spatial.py``) runs banded and the kernel takes the band's
    row window of the global upsample (``SpatialMesh.predict_band``)."""
    autocast = (torch.autocast(images.device.type, dtype=amp_dtype,
                               cache_enabled=False)
                if amp_dtype is not None else contextlib.nullcontext())
    with autocast, (spatial.banded() if spatial is not None
                    else contextlib.nullcontext()):
        if use_fused_kernel:
            feat, _f16, _f32 = model.features(images)
        else:
            out, _out16, _out32 = model(images)
    if use_fused_kernel:
        if spatial is not None:
            return spatial.predict_band(feat, images.shape[2:])
        return upsample_argmax(feat.contiguous(), images.shape[2:])
    return out.argmax(1).to(torch.int32)


def _count(model, images, labels, hist, correct, num_classes,
           use_fused_kernel, amp_dtype, spatial=None) -> None:
    """One batch's predictions added into ``hist`` and ``correct``, in
    place (the step a window captures). ``spatial``: a batch that splits
    over the mesh's data axis is counted on this rank's band of its data
    shard; another (a ragged tail) is counted whole, once, by rank 0
    (JAX cli.py:419-424 leaves it unsharded)."""
    if spatial is not None:
        if spatial.shards(images):
            images, labels = spatial.shard(images, labels)
        elif spatial.rank != 0:
            return
        else:
            spatial = None
    pred = predict(model, images, use_fused_kernel, amp_dtype, spatial)
    hist += confusion_matrix(labels, pred, num_classes)
    correct += (pred == labels).sum()


def counted_pixels(labels: torch.Tensor, spatial=None) -> int:
    """The pixels ``_count`` counts on this rank for ``labels``."""
    if spatial is None:
        return labels.numel()
    if spatial.shards(labels):
        return labels.numel() // (spatial.data_size * spatial.spatial_size)
    return labels.numel() if spatial.rank == 0 else 0


def _launch_counts() -> Dict[str, int]:
    return {name: module.LAUNCHES for name, module in _COUNTERS.items()}


class _WindowGraph:
    """K static input slots of one batch shape and the graph that walks
    them, adding into the accumulators it was captured with."""

    def __init__(self, k: int, images: torch.Tensor, labels: torch.Tensor):
        self.k = k
        self.images = torch.empty((k, *images.shape), dtype=images.dtype,
                                  device=images.device)
        self.labels = torch.empty((k, *labels.shape), dtype=labels.dtype,
                                  device=labels.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}

    def capture(self, step: Callable, hist: torch.Tensor,
                correct: torch.Tensor) -> None:
        """Warm the step up once on a side stream, over the first slot and
        scratch accumulators (cuDNN's plans, the kernels' libraries, the
        taps and the occupancy are made there, not inside the capture),
        then capture it over the K slots. ``thread_local``: the loader's
        decode threads and the fetch thread may call CUDA (``pin_memory``)
        while this thread captures; only this thread's calls must be
        capturable. A failed capture raises."""
        global GRAPH_CAPTURES
        device = self.images.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            step(self.images[0], self.labels[0], torch.zeros_like(hist),
                 torch.zeros_like(correct))
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for i in range(self.k):
                step(self.images[i], self.labels[i], hist, correct)
        after = _launch_counts()
        self.launches = {n: after[n] - before[n] for n in after}
        for name, n in self.launches.items():
            CAPTURED_LAUNCHES[name] += n
        self.graph = graph
        GRAPH_CAPTURES += 1

    def replay(self) -> None:
        global GRAPH_REPLAYS
        self.graph.replay()
        for name, n in self.launches.items():
            REPLAYED_LAUNCHES[name] += n
        GRAPH_REPLAYS += 1


class EvalGraphs:
    """The captured windows of one model and the int64 accumulators they
    add into, kept by the caller between evaluations (the CLI keeps one
    for its run, so each validation of training replays the windows the
    first captured). They are captured again when another model comes,
    or when a parameter or buffer of the model has moved (``model.to``
    reallocates); the model is held, so its memory cannot be reused
    under a live graph."""

    def __init__(self):
        self.model = None
        self.fingerprint: Tuple[int, ...] = ()
        self.hist = self.correct = torch.zeros(0)
        self.windows: Dict[tuple, _WindowGraph] = {}

    def accumulators(self, model, device, num_classes):
        """The zeroed accumulators for ``model``, after dropping every
        window captured for another model, place or shape of counts."""
        fingerprint = tuple(t.data_ptr() for t in
                            list(model.parameters()) + list(model.buffers()))
        if (model is not self.model or fingerprint != self.fingerprint
                or self.hist.shape[0] != num_classes):
            self.model, self.fingerprint, self.windows = model, fingerprint, {}
            self.hist = torch.zeros((num_classes, num_classes),
                                    dtype=torch.int64, device=device)
            self.correct = torch.zeros((), dtype=torch.int64, device=device)
        return self.hist.zero_(), self.correct.zero_()


def eval_counts(model, loader, num_classes: int, *,
                prepare: Callable[[Tuple], Tuple[torch.Tensor, torch.Tensor]],
                device: torch.device, use_fused_kernel: bool = True,
                amp_dtype: Optional[torch.dtype] = None,
                scan_window: int = 0,
                fetch_timeout: Optional[float] = FETCH_TIMEOUT,
                graphs: Optional[EvalGraphs] = None, spatial=None
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The whole dataset's int64 confusion matrix and correct-pixel count,
    on the device, and the pixel count. Nothing is read back: with pinned
    batches the host only enqueues work. ``scan_window`` K > 1: windows of
    K same-shaped batches, one CUDA-graph replay each on a card (module
    docstring), kept in ``graphs`` for the next call (a fresh
    ``EvalGraphs`` when None). ``fetch_timeout``: ``device_prefetch``'s
    watchdog. ``spatial``: the height-sharded mesh: every rank is given
    the whole batches and counts its band of each (``_count``); the
    counts are this rank's share, summed over the ranks by the caller. A
    window is captured only where the mesh's collectives can be
    (``SpatialMesh.capturable``: NCCL); otherwise every batch runs
    eagerly, to the same counts."""
    device = torch.device(device)
    replay = (scan_window > 1 and device.type == "cuda"
              and (spatial is None or spatial.capturable))
    if replay:
        graphs = graphs if graphs is not None else EvalGraphs()
        hist, correct = graphs.accumulators(model, device, num_classes)
    else:
        hist = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                           device=device)
        correct = torch.zeros((), dtype=torch.int64, device=device)
    total = 0

    def step(images, labels, h, c):
        _count(model, images, labels, h, c, num_classes, use_fused_kernel,
               amp_dtype, spatial)

    shape = None                  # the window's batch shape, from the first
    window: Optional[_WindowGraph] = None
    filled = 0                    # slots filled
    with torch.inference_mode():
        for images, labels in device_prefetch(
                (prepare(b) for b in loader), transfer_timeout=fetch_timeout,
                device=device):
            total += counted_pixels(labels, spatial)
            if replay:
                key = (tuple(images.shape), images.dtype,
                       tuple(labels.shape), labels.dtype)
                shape = key if shape is None else shape
                if key == shape:
                    if window is None:
                        wkey = (key, scan_window, use_fused_kernel,
                                amp_dtype, model.training)
                        window = graphs.windows.get(wkey)
                        if window is None:
                            window = graphs.windows[wkey] = _WindowGraph(
                                scan_window, images, labels)
                    window.images[filled].copy_(images)
                    window.labels[filled].copy_(labels)
                    filled += 1
                    if filled == scan_window:
                        if window.graph is None:
                            window.capture(step, hist, correct)
                        window.replay()
                        filled = 0
                    continue
            step(images, labels, hist, correct)
        # sub-window leftovers (JAX :237-239)
        for i in range(filled):
            step(window.images[i], window.labels[i], hist, correct)
    if replay:
        # the graphs' accumulators are zeroed by their next evaluation
        hist, correct = hist.clone(), correct.clone()
    return hist, correct, total


def evaluate(model, loader, num_classes: int, *,
             prepare: Callable[[Tuple], Tuple[torch.Tensor, torch.Tensor]],
             device: torch.device, use_fused_kernel: bool = True,
             amp_dtype: Optional[torch.dtype] = None,
             scan_window: int = 0, fetch_timeout: Optional[float] = FETCH_TIMEOUT,
             graphs: Optional[EvalGraphs] = None,
             print_results: bool = True,
             cross_process_sum: bool = False,
             spatial=None) -> Tuple[float, float]:
    """Whole-dataset eval; returns (precision, miou) like reference val()
    (JAX evaluate.py:133-258).

    ``cross_process_sum``: each rank of the process group was given a
    loader over
    its shard of the val set; the int64 counts are summed over the ranks
    before the metrics (``parallel/distributed.py::allreduce_counts``;
    JAX :158-164, :242-245), so every rank gets the metrics of the whole
    set, bit-identical to one process's, confusion matrices being sums of
    integers. ``spatial``: the height-sharded eval (``eval_counts``),
    whose counts are always summed over the ranks."""
    hist, correct, total = eval_counts(
        model, loader, num_classes, prepare=prepare, device=device,
        use_fused_kernel=use_fused_kernel, amp_dtype=amp_dtype,
        scan_window=scan_window, fetch_timeout=fetch_timeout,
        graphs=graphs, spatial=spatial)
    if cross_process_sum or spatial is not None:
        hist, correct, total = allreduce_counts(hist, correct, total)
    precision = int(correct.item()) / max(total, 1)
    miou_list = per_class_iou(hist.cpu()).numpy()
    miou = float(np.mean(miou_list))
    if print_results:
        print("precision per pixel for test: %.3f" % precision)
        print("mIoU for validation: %.3f" % miou)
        print(f"mIoU per class: {miou_list}")
    return precision, miou
