"""The arithmetic of the per-layer metrics, over a traced run's record.

A record (``drivers/train.py::result``) holds the cell's ``kind``
("train") and chips, the host spans of its window (``host``: steps,
seconds, the seconds in the feed's ``next`` and inside the step call),
the device trace of its traced block (``trace.profiled``: ``steps`` and
the device operations) and the yardstick's numbers for one step
(``flops_per_step``, ``ce_bound_ms_per_step``). Each reader of
``metrics/`` calls one function here for its kind; a reading that does
not apply to the record, or finds nothing to read, is None.
"""

from __future__ import annotations

from . import roofline, trace


def _host_ms(record, kind, span):
    host = record.get("host", {})
    if record.get("kind") != kind or span not in host or not host["steps"]:
        return None
    return host[span] / host["steps"] * 1e3


def fetch_wait_ms(record, kind):
    """Host ms a step waits in ``next()`` of ``device_prefetch``."""
    return _host_ms(record, kind, "fetch_s")


def enqueue_ms(record, kind):
    """Host ms a step spends inside the step call (no sync)."""
    return _host_ms(record, kind, "step_s")


def model_device_ms(record, kind):
    """Device ms a step in every kernel the port's ``ops/cuda`` did not
    launch (convolutions, BN, elementwise ops, the optimizer)."""
    if record.get("kind") != kind:
        return None
    return trace.per_step_ms(
        record, lambda n: not trace.is_port_kernel(n)) or None


def _share(bound_ms, time_ms):
    return 100.0 * bound_ms / time_ms if time_ms > 0 else None


def ce_roofline(record, kind):
    """% of the fused CE kernels' bound (forward and backward of each head
    the step sends through them) over their device time."""
    if record.get("kind") != kind or "ce_bound_ms_per_step" not in record:
        return None
    ms = trace.kernel_ms(record, lambda n: "ce_fwd" in n or "ce_bwd" in n)
    return _share(record["ce_bound_ms_per_step"] * record["steps"], ms)


def device_idle(record, kind):
    """% of the traced block's window in which no operation runs on the
    device: 1 - its busy seconds (the union of its kernels and copies)
    over its seconds. The block is traced without the host's operators
    (``trace.profiled``), whose record slows the host's enqueue by
    10-40%; what is left of the profiler's cost still lengthens a
    host-paced step a few percent (``harness.run_cell`` prints the
    block's seconds a step beside the untraced window's)."""
    if record.get("kind") != kind or not record["device"]:
        return None
    busy, window = trace.busy_and_window_s(record)
    return 100.0 * (1.0 - busy / window)


def mfu(record, kind):
    """% of the chips' bf16 tensor peak that the window's convolution and
    linear FLOPs (``flops.py``) fill."""
    host = record.get("host", {})
    if record.get("kind") != kind or not host.get("seconds"):
        return None
    rate = record["flops_per_step"] * host["steps"] / host["seconds"]
    return 100.0 * rate / (roofline.PEAK_OPS_PER_S["bf16_tensor"]
                           * record["chips"])
