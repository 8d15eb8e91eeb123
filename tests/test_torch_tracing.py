"""The port's spans and counters (``utils/logging_util.py``) on the CPU:
off by default and recording nothing, the train step's three phases, the
batch path's wait and preparation on their threads, the counters, and a
span's place on a ``torch.profiler`` trace's clock."""

import ctypes
import glob
import json
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from dasemanticsegmentationaml_tpu_torch.data.pipeline import (
    device_prefetch, prepare_batch)
from dasemanticsegmentationaml_tpu_torch.ops.cuda import build
from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce
from dasemanticsegmentationaml_tpu_torch.train.supervised import (
    make_train_step)
from dasemanticsegmentationaml_tpu_torch.utils import logging_util as lu

TRAIN = ("train.forward", "train.backward", "train.optimizer")


class Tiny(nn.Module):
    """Three heads at strides 1, 2 and 4, as ``BiSeNet.features`` gives."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 19, 1)

    def features(self, x):
        y = self.conv(x)
        return [y, F.avg_pool2d(y, 2), F.avg_pool2d(y, 4)]


@pytest.fixture(autouse=True)
def tracing_off():
    lu.disable()
    yield
    lu.disable()


def tiny_step():
    torch.manual_seed(0)
    model = Tiny().train()
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    return make_train_step(model, opt)


def host_batches(n, b=2, hw=(16, 32), seed=0):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.integers(0, 256, (b, *hw, 3),
                                           dtype=np.uint8)),
             torch.from_numpy(rng.integers(0, 19, (b, *hw), dtype=np.uint8)))
            for _ in range(n)]


def prepared(batches):
    for images, labels in batches:
        yield prepare_batch(images, labels, device=torch.device("cpu"))


def test_off_returns_the_shared_no_op_and_records_nothing():
    lu.enable()
    lu.disable()
    first, second = lu.span("train.forward"), lu.span("data.wait")
    assert first is second is lu.NO_SPAN
    step = tiny_step()
    for images, labels in device_prefetch(prepared(host_batches(2)),
                                          transfer_timeout=30.0):
        step(images, labels)
    assert lu.collect()["spans"] == [] and lu.collect()["steps"] == 0


def test_the_train_step_records_its_three_phases_in_order():
    step = tiny_step()
    batch = [tuple(prepare_batch(*b, device=torch.device("cpu")))
             for b in host_batches(3)]
    lu.enable()
    for images, labels in batch:
        step(images, labels)
    got = lu.collect()
    lu.disable()
    spans = [s for s in got["spans"] if s.name in TRAIN]
    assert got["steps"] == 3
    assert [s.name for s in spans] == list(TRAIN) * 3
    assert [s.step for s in spans] == [0] * 3 + [1] * 3 + [2] * 3
    assert all(s.parent is None and s.t1_ns >= s.t0_ns for s in spans)
    assert all(a.t1_ns <= b.t0_ns for a, b in zip(spans, spans[1:]))
    assert len({s.thread for s in spans}) == 1


@pytest.mark.parametrize("timeout", [30.0, None])
def test_prefetch_records_the_wait_and_the_preparation(timeout):
    """With the watchdog, ``prepare_batch`` runs on the fetching thread;
    without, inside the consumer's wait."""
    step = tiny_step()
    lu.enable()
    n = 0
    for images, labels in device_prefetch(prepared(host_batches(4)),
                                          transfer_timeout=timeout):
        step(images, labels)
        n += 1
    spans = lu.collect()["spans"]
    lu.disable()
    main = {s.thread for s in spans if s.name in TRAIN}
    waits = [s for s in spans if s.name == "data.wait"]
    prepares = [s for s in spans if s.name == "data.prepare"]
    assert n == 4 and len(prepares) == 4
    # two fetched ahead, then one as each batch is taken, the last two
    # finding the end
    assert len(waits) == 6 and {s.thread for s in waits} == main
    if timeout is None:
        assert {s.thread for s in prepares} == main
        assert {s.parent for s in prepares} == {"data.wait"}
    else:
        assert main.isdisjoint({s.thread for s in prepares})
        assert {s.parent for s in prepares} == {None}
    # a wait between two steps carries the step it delays
    assert [s.step for s in waits] == [0, 0, 0, 1, 2, 3]


def test_snapshot_reads_the_launch_counters_where_they_are(monkeypatch):
    monkeypatch.setattr(fused_ce, "FWD_LAUNCHES", 7)
    monkeypatch.setattr(fused_ce, "BWD_LAUNCHES", 5)
    snap = lu.snapshot()
    assert snap["fused_ce.FWD_LAUNCHES"] == 7
    assert snap["fused_ce.BWD_LAUNCHES"] == 5
    assert fused_ce.FWD_LAUNCHES == 7
    assert {"kernels.load_s", "upsample_argmax.LAUNCHES",
            "int8_conv.LAUNCHES", "copy_probe.BOUNCE_LAUNCHES.8",
            "evaluate.REPLAYED_LAUNCHES.int8_conv"} <= set(snap)


def test_load_library_counts_its_builds_and_seconds(tmp_path, monkeypatch):
    """A first load that builds counts one build of its source; a load
    that finds the library built counts none; both add seconds."""
    built = []

    def fake_build(command, src, so_path, libs=()):
        if so_path in built:
            return None
        built.append(so_path)
        return "ptxas info"

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "build_library", fake_build)
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(build, "BUILD_LOGS", {})
    before = lu.snapshot()
    for _ in range(2):
        monkeypatch.setattr(build, "_LIBS", {})
        build.load_library("tile_roll")
        build.load_library("tile_roll")  # loaded: nothing more
    after = lu.snapshot()
    key = "kernels.builds.tile_roll"
    assert after[key] - before.get(key, 0) == 1
    assert after["kernels.load_s"] > before["kernels.load_s"]
    assert build.BUILD_LOGS == {"tile_roll": "ptxas info"}
    assert ctypes.CDLL is build.ctypes.CDLL


def test_a_span_maps_onto_its_record_function_twin():
    """In a CPU profile, an annotated span's start mapped onto the trace's
    clock lies within 1 ms of its range's. The range opens after the
    span's clock read, later still when the thread is preempted between
    the two on a loaded host: the least gap is the map's offset."""
    from torch.profiler import ProfilerActivity, profile

    step = tiny_step()
    images, labels = prepare_batch(*host_batches(1)[0],
                                   device=torch.device("cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lu.enable(annotate=True)
        for _ in range(3):
            step(images, labels)
        lu.disable()
    got = lu.collect()
    events, base = exported(prof)
    for name in TRAIN:
        twins = sorted(e["ts"] for e in events if e.get("name") == name
                       and e.get("cat") == "user_annotation")
        mine = [lu.to_trace_us(s.t0_ns, got["anchor"], base)
                for s in got["spans"] if s.name == name]
        assert len(twins) == len(mine) == 3
        assert abs(min(b - a for a, b in zip(mine, twins))) < 1000.0


def exported(prof):
    """(the Chrome trace's events, its ``baseTimeNanoseconds``)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return trace["traceEvents"], trace["baseTimeNanoseconds"]


def test_profiler_trace_shows_the_spans(tmp_path):
    """``--profile_dir``'s trace holds the five spans as ranges, the
    fetching thread's too; tracing is off once the trace is written."""
    prof = lu.Profiler(str(tmp_path), num_steps=3)
    step = tiny_step()
    for images, labels in device_prefetch(prepared(host_batches(5)),
                                          transfer_timeout=30.0):
        step(images, labels)
        prof.step()
    prof.close()
    assert lu.span("train.forward") is lu.NO_SPAN
    (path,) = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(TRAIN) | {"data.wait", "data.prepare"} <= names
