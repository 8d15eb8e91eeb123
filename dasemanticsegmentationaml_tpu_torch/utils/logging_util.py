"""Observability: TB-compatible scalars, structured JSONL, a trace.

``JsonlLogger`` and ``make_writer`` are copied from
``dasemanticsegmentationaml_tpu/utils/logging_util.py`` (:18-56), which the
port may not import. The reference logs tensorboardX scalars named
loss_step / epoch/loss_epoch_train / epoch/precision_val / 'epoch/miou val'
(reference train.py:98,103,119-120); the names are kept. ``Profiler`` is
the ``torch.profiler`` counterpart of the JAX one (:59-86), behind
``--profile_dir``.

Spans and counters (the port's own; the JAX package has none):

- ``span(name)`` times a phase where the work happens. Tracing is off
  until ``enable()``: ``span`` then returns one shared no-op context and
  records nothing. On, each span keeps ``Span(name, parent, step, thread,
  t0_ns, t1_ns)`` in memory on ``time.perf_counter_ns``: ``parent`` is
  the name of the enclosing span of the same thread, ``step`` the train
  step it belongs to (``end_step`` advances it). ``enable(annotate=True)``
  also opens a ``torch.profiler.record_function`` of the span's name, so
  a profile shows it (``Profiler`` asks for this); the span's interval
  lies inside that range and leaves out its cost.
- ``collect()`` returns the spans with the clock anchor taken at
  ``enable``, ``(perf_counter_ns, time_ns)``; ``to_trace_us`` maps a span
  time onto a ``torch.profiler`` Chrome trace's ``ts`` (microseconds
  after the trace's ``baseTimeNanoseconds``, on ``time.time_ns``'s clock).
- ``count(name, n)`` adds to a counter, always on (rare events: a kernel
  build); ``snapshot()`` returns the counters with the kernels' launch
  counters, which stay where they are kept (``ops/cuda/*.py``,
  ``train/evaluate.py``).

The spans: ``train.forward`` (``zero_grad`` and the loss: the forward and
the three CE heads), ``train.backward`` and ``train.optimizer`` of an
eager step in ``train/supervised.py::make_train_step``, and of a graphed
step ``train.replay`` (the batch copied into the graph's slots and the
replay) and, once a graph, ``train.capture``; ``data.wait`` (the
consumer's wait for a batch in ``data/pipeline.py::device_prefetch``) and
``data.prepare`` (``prepare_batch``, on the thread that fetches). The
counters: ``kernels.builds.<source>`` (one a ``nvcc`` run),
``kernels.load_s`` (seconds in ``ops/cuda/build.py::load_library``, build
and ``dlopen``, summed over its calls), and, one a train step on CUDA,
``train.graph_replays`` or ``train.eager_steps.<reason>``, and
``train.graph_captures``, ``train.captured_launches.<kernel>`` and
``train.replayed_launches.<kernel>`` (the launches the train step's graph
holds, added at its capture and at each replay).
"""

from __future__ import annotations

import importlib
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple


class JsonlLogger:
    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        else:
            self._f = None

    def log(self, **fields):
        if self._f is None:
            return
        fields.setdefault("time", time.time())
        self._f.write(json.dumps(fields) + "\n")

    def close(self):
        if self._f is not None:
            self._f.close()


def make_writer(enabled: bool, comment: str = ""):
    """tensorboardX SummaryWriter when installed, else the native writer.

    utils/tb_writer.py writes real events.out.tfevents files from scratch
    (TFRecord framing + Event proto), so `tensorboard --logdir runs` works
    either way.
    """
    if not enabled:
        return None
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(comment=comment)
    except Exception:
        from .tb_writer import EventWriter, default_logdir

        return EventWriter(default_logdir(comment))


class Profiler:
    """A ``torch.profiler`` trace of the start of a run (JAX
    logging_util.py:59-86). The trainers call ``step()`` after each step:
    the first call starts the trace and the ``num_steps``-th stops it
    (``close()`` stops it earlier), which writes it to ``trace_dir`` as a
    Chrome trace (``*.pt.trace.json``, read by TensorBoard's profile
    plugin). The card's kernels are recorded when CUDA is available, and
    the program's spans (``span``) as ranges of their names, on every
    thread where this torch records them all (``_ExperimentalConfig``'s
    ``profile_all_threads``): tracing is on from the trace's start to its
    stop."""

    def __init__(self, trace_dir: Optional[str], num_steps: int = 8):
        self.trace_dir = trace_dir
        self.num_steps = num_steps
        self._prof = None
        self._count = 0

    def step(self):
        if self.trace_dir is None:
            return
        if self._prof is None and self._count == 0:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.trace_dir),
                experimental_config=_all_threads(torch))
            self._prof.start()
            enable(annotate=True)
        self._count += 1
        if self._prof is not None and self._count >= self.num_steps:
            self.close()

    def close(self):
        if self._prof is not None:
            disable()
            self._prof.stop()
            self._prof = None


def _all_threads(torch):
    """A profiler config that records every thread's ranges (the fetching
    thread's ``data.prepare``), or None where this torch lacks it."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


class Span(NamedTuple):
    name: str
    parent: Optional[str]
    step: int
    thread: int
    t0_ns: int
    t1_ns: int


class _Recording:
    """What one ``enable()`` records: the spans, the step index and the
    clock anchor."""

    def __init__(self, annotate: bool):
        self.record_function = None
        if annotate:
            import torch

            self.record_function = torch.profiler.record_function
        self.spans: List[Span] = []
        self.step = 0
        self.anchor = (time.perf_counter_ns(), time.time_ns())


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()
_ON: Optional[_Recording] = None
_LAST: Optional[_Recording] = None
#: each thread's open spans, innermost last
_OPEN = threading.local()


class _Span:
    __slots__ = ("name", "rec", "parent", "step", "t0", "rf")

    def __init__(self, name: str, rec: _Recording):
        self.name = name
        self.rec = rec

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.step = self.rec.step
        # inside its range: entering and leaving one under a CPU profile
        # costs 10-30 us, which is not the program's
        self.rf = None
        if self.rec.record_function is not None:
            self.rf = self.rec.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _OPEN.stack.pop()
        self.rec.spans.append(Span(self.name, self.parent, self.step,
                                   threading.get_ident(), self.t0, t1))
        return False


def span(name: str):
    """A context that records ``name``'s interval while tracing is on."""
    rec = _ON
    if rec is None:
        return NO_SPAN
    return _Span(name, rec)


def end_step() -> None:
    """The train step ends: later spans belong to the next step."""
    rec = _ON
    if rec is not None:
        rec.step += 1


def enable(annotate: bool = False) -> None:
    """Start recording spans afresh, at step 0 (``annotate``: each span
    also a ``torch.profiler.record_function``)."""
    global _ON, _LAST
    _ON = _LAST = _Recording(annotate)


def disable() -> None:
    global _ON
    _ON = None


def collect() -> dict:
    """{"spans": [Span] by start, "steps": steps ended, "anchor":
    (perf_counter_ns, time_ns) at ``enable``} of the recording on, or of
    the last one (empty, anchor None, where tracing never ran)."""
    rec = _LAST
    if rec is None:
        return {"spans": [], "steps": 0, "anchor": None}
    return {"spans": sorted(rec.spans, key=lambda s: s.t0_ns),
            "steps": rec.step, "anchor": rec.anchor}


def to_trace_us(t_ns: int, anchor: Tuple[int, int],
                base_time_ns: int) -> float:
    """A span time (``perf_counter_ns``) as a Chrome trace's ``ts``: the
    microseconds after ``base_time_ns`` (the trace's
    ``baseTimeNanoseconds``) on ``time.time_ns``'s clock."""
    return (t_ns - anchor[0] + anchor[1] - base_time_ns) / 1e3


_COUNTS: Dict[str, float] = {}
_COUNT_LOCK = threading.Lock()
#: the launch counters other modules keep: (module of the package, its
#: attributes), an int or a dict of ints each
LAUNCH_COUNTERS = (
    ("ops.cuda.fused_ce", ("FWD_LAUNCHES", "BWD_LAUNCHES")),
    ("ops.cuda.upsample_argmax", ("LAUNCHES", "WINDOW_LAUNCHES")),
    ("ops.cuda.fused_stdc", ("S1_LAUNCHES", "S2_LAUNCHES")),
    ("ops.cuda.int8_conv", ("LAUNCHES",)),
    ("ops.cuda.tile_roll", ("LAUNCHES",)),
    ("ops.cuda.copy_probe", ("BLOCK_LAUNCHES", "DIRECT_LAUNCHES",
                             "BOUNCE_LAUNCHES")),
    ("train.evaluate", ("CAPTURED_LAUNCHES", "REPLAYED_LAUNCHES")),
)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` (from any thread)."""
    with _COUNT_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def snapshot() -> Dict[str, float]:
    """The counters (``kernels.load_s`` at 0.0 before any load) and the
    launch counters of ``LAUNCH_COUNTERS`` as ``<module>.<attribute>``
    (``.<key>`` after a dict's), read where they are kept."""
    with _COUNT_LOCK:
        out = {"kernels.load_s": 0.0, **_COUNTS}
    package = __name__.rsplit(".", 2)[0]
    for module, names in LAUNCH_COUNTERS:
        mod = importlib.import_module(f"{package}.{module}")
        short = module.rsplit(".", 1)[-1]
        for attr in names:
            value = getattr(mod, attr)
            if isinstance(value, dict):
                out.update({f"{short}.{attr}.{k}": v
                            for k, v in value.items()})
            else:
                out[f"{short}.{attr}"] = value
    return out
