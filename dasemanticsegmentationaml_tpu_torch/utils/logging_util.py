"""Observability: TB-compatible scalars + structured JSONL.

``JsonlLogger`` and ``make_writer`` are copied from
``dasemanticsegmentationaml_tpu/utils/logging_util.py`` (:18-56), which the
port may not import. The reference logs tensorboardX scalars named
loss_step / epoch/loss_epoch_train / epoch/precision_val / 'epoch/miou val'
(reference train.py:98,103,119-120); the names are kept. The JAX
``Profiler`` wraps ``jax.profiler`` and is not ported (``--profile_dir``
stops).
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
