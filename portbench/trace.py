"""Host spans and the device trace of a traced block of steps.

``Spans`` adds up the host seconds of the benchmark's calls into the
program's layers (``perf_counter``); with ``annotate`` each span is also a
``torch.profiler.record_function`` range, so that the device trace can
say what the host was doing while the device sat idle.

``profiled(fn)`` runs ``fn`` and a ``synchronize`` under
``torch.profiler``, writes the Chrome trace to a temporary file, and
returns it as plain lists: device operations (kernels, copies, sets) and
host ranges, times in microseconds of the profiler's clock. With
``host`` (CPU and CUDA activities) the window is a ``portbench.window``
range and the host's ranges come with it; the profiler's record of every
host operator then slows the host's enqueue by 10-40% a step (PERF.md).
Without it (CUDA activity alone, a few percent) the window is the
block's host seconds, ending where its last device operation ends, and
there are no host ranges. ``summary`` turns a device-only record into
the device's busy and window seconds and the run's ``breakdown``, with
the idle gaps read from a host record of its own.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: parts of the names of the kernels the port's ``ops/cuda`` launches
PORT_KERNELS = ("ce_fwd", "ce_bwd", "upsample_argmax", "int8_conv",
                "fused_cat", "copy_block", "copy_direct", "copy_bounce",
                "tile_roll")
WINDOW = "portbench.window"
PREFIX = "portbench."


class Spans:
    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.seconds: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = (torch.profiler.record_function(PREFIX + name) if self.annotate
              else contextlib.nullcontext())
        t = time.perf_counter()
        with rf:
            yield
        self.seconds[name] += time.perf_counter() - t


def profiled(fn, device, host: bool = True) -> dict:
    """Run ``fn()`` traced; the trace as ``{"window_us": [start, end],
    "device": [[name, cat, ts, dur]], "host_ops": [[name, cat, ts, dur]]}``,
    clipped to the window; ``host_ops`` holds the benchmark's ranges and the
    operators the host ran (``host`` only)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        with (torch.profiler.record_function(WINDOW) if host
              else contextlib.nullcontext()):
            fn()
            if cuda:
                torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return record_of(events, None if host else seconds)


def record_of(events: List[dict], seconds: Optional[float] = None) -> dict:
    """The record of a trace's ``events``: its window is the
    ``portbench.window`` range, or where ``seconds`` is given, the
    ``seconds`` that end where the last device operation ends."""
    device, host = [], []
    if seconds is not None:
        device = [[e["name"], e["cat"], float(e["ts"]), float(e["dur"])]
                  for e in events if e.get("ph") == "X" and "dur" in e
                  and e.get("cat") in DEVICE_CATS]
        end = max((ts + dur for _, _, ts, dur in device), default=0.0)
        return {"window_us": [end - seconds * 1e6, end], "device": device,
                "host_ops": host}
    window = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no portbench.window range")
    w0, w1 = window[0]
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            # a device operation of the window: it starts before the
            # window's synchronize returns
            if ts + dur > w0 and ts < w1:
                device.append([e["name"], cat, ts, dur])
        elif cat in ("user_annotation", "cpu_op") and ts < w1 \
                and ts + dur > w0 and e["name"] != WINDOW:
            host.append([e["name"], cat, ts, dur])
    end = max([w1] + [ts + dur for _, _, ts, dur in device])
    return {"window_us": [w0, end], "device": device, "host_ops": host}


def busy_intervals(record: dict) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, in the window."""
    w0, w1 = record["window_us"]
    spans = sorted((max(ts, w0), min(ts + dur, w1))
                   for _, _, ts, dur in record["device"])
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        elif b > a:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_and_window_s(record: dict) -> Tuple[float, float]:
    w0, w1 = record["window_us"]
    busy = sum(b - a for a, b in busy_intervals(record))
    return busy * 1e-6, (w1 - w0) * 1e-6


def _host_activities(record: dict, gaps) -> List[str]:
    """What the host did over each gap [a, b] of ``gaps`` (in order): the
    benchmark's range and the operator that overlap it the most, found in
    one sweep over the host's ranges sorted by start."""
    events = sorted(record["host_ops"], key=lambda e: e[2])
    active: list = []  # heap of (end, index) of ranges begun before b
    out, i = [], 0
    for a, b in gaps:
        while i < len(events) and events[i][2] < b:
            heapq.heappush(active, (events[i][2] + events[i][3], i))
            i += 1
        while active and active[0][0] <= a:
            heapq.heappop(active)
        best = {"user_annotation": ("", 0.0), "cpu_op": ("", 0.0)}
        for end, k in active:
            name, cat, ts, _dur = events[k]
            overlap = min(b, end) - max(a, ts)
            if overlap > best[cat][1]:
                best[cat] = (name, overlap)
        span = best["user_annotation"][0].replace(PREFIX, "") or "outside"
        op = best["cpu_op"][0]
        out.append(f"{span}>{op}" if op else span)
    return out


def summary(record: dict, host_record: Optional[dict] = None,
            top: int = 10) -> dict:
    """{"busy_s", "window_s", "breakdown": {"device_ops", "idle_gaps"}}:
    ``record``'s busy and window seconds and its device operations by
    total seconds, and ``host_record``'s idle seconds (``record``'s where
    None) by what the host was doing, each the ``top`` largest."""
    busy, window = busy_and_window_s(record)
    ops: Dict[str, float] = defaultdict(float)
    for name, _cat, _ts, dur in record["device"]:
        ops[name[:160]] += dur * 1e-6
    idle: Dict[str, float] = defaultdict(float)
    host_record = host_record or record
    w0, w1 = host_record["window_us"]
    edges = [w0] + [t for iv in busy_intervals(host_record)
                    for t in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    for (a, b), what in zip(gaps, _host_activities(host_record, gaps)):
        idle[what] += (b - a) * 1e-6
    largest = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": busy, "window_s": window,
            "breakdown": {"device_ops": largest(ops),
                          "idle_gaps": largest(idle)}}


def kernel_ms(record: dict, match=None, cat: str = "kernel") -> float:
    """Device milliseconds of the window's operations of ``cat`` whose
    name ``match`` accepts (all where None)."""
    return sum(dur for name, c, _ts, dur in record["device"]
               if c == cat and (match is None or match(name))) * 1e-3


def kernel_count(record: dict, match) -> int:
    return sum(1 for name, c, _ts, _dur in record["device"]
               if c == "kernel" and match(name))


def is_port_kernel(name: str) -> bool:
    return any(part in name for part in PORT_KERNELS)


def per_step_ms(record: dict, match, cat: str = "kernel"):
    """``kernel_ms`` a step of the traced block."""
    return kernel_ms(record, match, cat) / record["steps"]
