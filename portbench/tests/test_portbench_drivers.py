"""Each traffic driver for a few steps on the CPU, with the port's plain
kernels, at a size a test run holds; the result line's keys; and the
faults and the control that ``correct`` has to catch."""

import json
import math
import time

import pytest

from portbench import calibrate, harness
from portbench.tests.conftest import SMALL

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checked"]
SEED = 2**31 + 7


def pieces(cell, traffic=None, dtype=None):
    """(config, traffic, limits) of ``cell`` at its small size."""
    _, config, base, limits = harness.cell(cell)
    config = {**config, **({"dtype": dtype} if dtype else {})}
    return config, {**base, **SMALL[cell], **(traffic or {})}, limits


def driver_out(cell, trace=False, fault=None, dtype=None, traffic=None,
               seed=SEED):
    config, traf, limits = pieces(cell, traffic, dtype)
    r = harness.Run(cell, config, traf, limits, seed, 0.5, trace, "cpu", 1,
                    time.time(), fault)
    out = harness.driver(traf).run(r)
    return out, harness.is_correct(harness.checked(out["numbers"], limits))


def run(cell, trace=False, fault=None, dtype=None, seed=SEED):
    config = {"dtype": dtype} if dtype else {}
    return harness.run_cell(cell, seed, 0.5, trace, "cpu", 1, time.time(),
                            overrides={"traffic": SMALL[cell],
                                       "config": config}, fault=fault)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_reports(cell, trace):
    r = run(cell, trace)
    keys = list(r)
    assert keys[-1] == "checked"
    assert [k for k in keys if k in KEYS] == KEYS
    assert ("breakdown" in r) == trace
    assert r["attempted"] > 0 and r["failed"] == 0
    bench = harness.benchmark()
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        wanted = {m["name"] for m in bench["per_layer"]
                  if cell in m["workloads"]}
        # a CPU run has no device trace: only the host's readings come
        assert set(r["metrics"]) <= wanted
        assert any(k.startswith("mfu.") for k in r["metrics"])
    else:
        wanted = {m["name"] for m in bench["end_to_end"]
                  if cell in m.get("workloads", [cell])}
        assert set(r["metrics"]) == wanted
        assert all(m["value"] > 0 for m in r["metrics"].values())
    for c in r["checked"].values():
        assert math.isfinite(c["value"]) and c["limit"] > 0
    json.dumps(r)


#: the faults each cell can have, planted under its timed path
FAULTS = {"train": ("unchanged", "half_batch", "lr_x10")}


@pytest.mark.parametrize("cell, fault", [
    (c, f) for c in CELLS for f in FAULTS[pieces(c)[1]["driver"]]])
def test_a_fault_is_not_correct(cell, fault):
    assert driver_out(cell, fault=fault, dtype="float32")[1] is False


@pytest.mark.parametrize("cell", CELLS)
def test_sound_fp32_is_correct(cell):
    """The same runs without the fault, in fp32: the faults' test sees
    the fault and not the size."""
    assert driver_out(cell, dtype="float32")[1] is True


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    config, traffic, limits = pieces(cell)
    r = harness.Run(cell, config, traffic, limits, 11, 0.5, False, "cpu", 1,
                    time.time())
    numbers = calibrate.control(r, 11)
    assert not harness.is_correct(harness.checked(numbers, limits))
