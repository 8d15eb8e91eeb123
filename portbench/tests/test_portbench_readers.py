"""The per-layer metric readers on a recorded trace."""

import pytest

from portbench import harness, roofline, trace

#: a Chrome trace as the profiler writes it: a window of 10 ms (ts in us)
#: holding two steps' device operations and the host's ranges
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "portbench.window",
     "ts": 1000.0, "dur": 10000.0},
    {"ph": "X", "cat": "user_annotation", "name": "portbench.fetch",
     "ts": 1000.0, "dur": 1000.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1100.0,
     "dur": 800.0},
    {"ph": "X", "cat": "user_annotation", "name": "portbench.step",
     "ts": 2000.0, "dur": 8000.0},
    {"ph": "X", "cat": "kernel", "name": "void ce_fwd_band_kernel<19>()",
     "ts": 2000.0, "dur": 500.0},
    {"ph": "X", "cat": "kernel", "name": "void ce_bwd_band_kernel<19>()",
     "ts": 2500.0, "dur": 1500.0},
    {"ph": "X", "cat": "kernel", "name": "cudnn_conv_kernel",
     "ts": 4000.0, "dur": 3000.0},
    {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce_Sum",
     "ts": 7000.0, "dur": 1000.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
     "ts": 1200.0, "dur": 400.0},
    {"ph": "X", "cat": "kernel", "name": "upsample_argmax_band_kernel",
     "ts": 9000.0, "dur": 200.0},
    {"ph": "X", "cat": "kernel", "name": "outside_the_window",
     "ts": 20000.0, "dur": 5.0},
    {"ph": "i", "cat": "kernel", "name": "an instant event", "ts": 3000.0},
]


def record(kind="train", chips=1):
    r = trace.record_of(EVENTS)
    r.update(kind=kind, chips=chips, steps=2, flops_per_step=1e12,
             ce_bound_ms_per_step=0.1,
             host={"steps": 10, "seconds": 0.5, "fetch_s": 0.02,
                   "step_s": 0.3, "images_per_step": 16})
    return r


def read(name, rec):
    return harness.reader(name).read(rec)


def test_record_of_keeps_the_window():
    r = record()
    assert r["window_us"] == [1000.0, 11000.0]
    assert len(r["device"]) == 6
    assert {h[0] for h in r["host_ops"]} == {
        "portbench.fetch", "aten::copy_", "portbench.step"}


#: the device's operations alone, as a trace of the device alone holds
DEVICE_ONLY = [e for e in EVENTS if e["cat"] in trace.DEVICE_CATS
               and e["name"] != "outside_the_window"]


def test_a_device_record_ends_at_its_last_operation():
    r = trace.record_of(DEVICE_ONLY, seconds=0.009)
    # the last operation ends at 9200 us
    assert r["window_us"] == [200.0, 9200.0]
    assert r["host_ops"] == [] and len(r["device"]) == 6
    busy, window = trace.busy_and_window_s(r)
    assert window == pytest.approx(0.009)
    # 1.2-1.6, 2.0-8.0, 9.0-9.2 ms busy
    assert busy == pytest.approx(0.0066)
    r.update(kind="train", steps=2)
    assert read("device_idle.train", r) == pytest.approx(
        100 * (1 - 0.0066 / 0.009))


def test_idle_gaps_come_from_the_host_record():
    device = trace.record_of(DEVICE_ONLY, 0.009)
    s = trace.summary(device, record())
    assert s["busy_s"] == trace.busy_and_window_s(device)[0]
    gaps = dict((k, v) for k, v in s["breakdown"]["idle_gaps"])
    assert gaps["fetch>aten::copy_"] == pytest.approx(0.0006)


def test_busy_and_idle():
    busy, window = trace.busy_and_window_s(record())
    assert window == pytest.approx(0.010)
    # 1.2-1.6, 2.0-8.0, 9.0-9.2 ms busy
    assert busy == pytest.approx(0.0066)
    s = trace.summary(record())
    gaps = dict((k, v) for k, v in s["breakdown"]["idle_gaps"])
    assert gaps["fetch>aten::copy_"] == pytest.approx(0.0006)
    assert sum(gaps.values()) == pytest.approx(0.0034)
    assert s["breakdown"]["device_ops"][0] == ["cudnn_conv_kernel",
                                               pytest.approx(0.003)]


@pytest.mark.parametrize("name, chips, want", [
    ("fetch_wait_ms.train", 1, 2.0),
    ("enqueue_ms.train", 1, 30.0),
    # every kernel but those of ops/cuda (CE, upsample_argmax), 2 steps
    ("model_device_ms.train", 1, (3000 + 1000) / 2 * 1e-3),
    ("ce_roofline.train", 1, 100 * 0.2 / 2.0),
    # 6.6 ms busy in the traced block's 10 ms
    ("device_idle.train", 1, 100 * (1 - 0.0066 / 0.010)),
    ("mfu.train", 4, 100 * 20e12 / (4 * 989e12)),
    ("mfu.train", 1, 100 * 20e12 / 989e12),
])
def test_reader(name, chips, want):
    assert read(name, record("train", chips)) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    m["name"] for m in harness.benchmark()["per_layer"]])
def test_reader_of_another_kind_reads_nothing(name):
    assert read(name, record("another")) is None


def test_nothing_to_read_is_none():
    r = record("train", 1)
    r["device"] = []
    for name in ("ce_roofline.train", "model_device_ms.train",
                 "device_idle.train"):
        assert read(name, r) is None


def test_peak_used_is_the_table():
    assert roofline.PEAK_OPS_PER_S["bf16_tensor"] == 989e12
