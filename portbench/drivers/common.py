"""What the drivers share: the program's models from a state dict, the
feed through the program's batch path, the timed loop of training steps
and its traced block, and the device's readings."""

from __future__ import annotations

import gc
import itertools
import time
from typing import Callable, Dict, List

import torch

from .. import trace
from ..reference import model as M


def g_shapes() -> Dict[str, tuple]:
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in M.BiSeNet(19).state_dict().items()}


def program_g(state, device):
    """The port's BiSeNet-STDC813 holding ``state`` (train mode)."""
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import BiSeNet

    with torch.device("meta"):
        g = BiSeNet(19, "STDCNet813", use_conv_last=False)
    g = g.to_empty(device=device)
    g.load_state_dict(state)
    return g.train()


def amp_dtype(config: dict):
    return {"bfloat16": torch.bfloat16, "float32": None}[config["dtype"]]


def feed(batches: List[tuple], prepare: Callable, device):
    """The pool's batches, cycled, through the program's ``prepare`` and
    ``device_prefetch`` (two ahead, each fetch in a watchdog thread), as
    the trainers take them."""
    from dasemanticsegmentationaml_tpu_torch.data.pipeline import (
        FETCH_TIMEOUT, device_prefetch)

    def prepared():
        for batch in itertools.cycle(batches):
            yield prepare(*batch)

    return device_prefetch(prepared(), transfer_timeout=FETCH_TIMEOUT,
                           device=device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_kind(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_steps(it, step: Callable, spans: trace.Spans, *, seconds=None,
              steps=None, device=None) -> dict:
    """Steps from the feed ``it`` until ``seconds`` have passed on the host
    clock (or ``steps`` are done), then a ``synchronize``: {"steps",
    "seconds"} of the window."""
    n = 0
    t0 = time.perf_counter()
    while (steps is not None and n < steps) or (
            steps is None and time.perf_counter() - t0 < seconds):
        with spans("fetch"):
            batch = next(it)
        with spans("step"):
            step(*batch)
        n += 1
    with spans("sync"):
        sync(device)
    return {"steps": n, "seconds": time.perf_counter() - t0}


def timed(run, it, step: Callable, *, images_per_step: int) -> dict:
    """The window of ``run.seconds`` (host spans of fetch and step), and
    with ``run.trace`` traced blocks of the traffic's ``trace_steps``
    after it: one with the host's ranges, for the idle gaps
    (``host_record``), then two of the device alone, of which the readers
    read the second: a process's first profiled blocks run its steps
    slower (on an H100, 38-45 ms a step against 35 untraced; PERF.md):
    {"window": {...}, "spans": {...}, "record": {...} or None}."""
    spans = trace.Spans(annotate=run.trace)
    window = run_steps(it, step, spans, seconds=run.seconds,
                       device=run.device)
    window["images"] = window["steps"] * images_per_step
    result = {"window": window, "spans": dict(spans.seconds), "record": None}
    if run.trace:
        def traced(host):
            box = {}

            def block():
                box.update(run_steps(it, step, trace.Spans(annotate=host),
                                     steps=run.traffic["trace_steps"],
                                     device=run.device))

            record = trace.profiled(block, run.device, host=host)
            record.update(steps=box["steps"], seconds=box["seconds"])
            return record

        host_record = traced(True)
        traced(False)
        result["record"] = traced(False)
        result["record"]["host_record"] = host_record
    return result
