"""Observability: TB-compatible scalars, structured JSONL, a trace.

``JsonlLogger`` and ``make_writer`` are copied from
``dasemanticsegmentationaml_tpu/utils/logging_util.py`` (:18-56), which the
port may not import. The reference logs tensorboardX scalars named
loss_step / epoch/loss_epoch_train / epoch/precision_val / 'epoch/miou val'
(reference train.py:98,103,119-120); the names are kept. ``Profiler`` is
the ``torch.profiler`` counterpart of the JAX one (:59-86), behind
``--profile_dir``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


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
    plugin). The card's kernels are recorded when CUDA is available."""

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
                    self.trace_dir))
            self._prof.start()
        self._count += 1
        if self._prof is not None and self._count >= self.num_steps:
            self.close()

    def close(self):
        if self._prof is not None:
            self._prof.stop()
            self._prof = None
