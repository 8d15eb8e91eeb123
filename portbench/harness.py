"""One run of one cell: find its pieces by name, run its driver, read its
metrics, decide ``correct``, and build the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>
.json``) and a traffic mix (``traffic/<name>.json``); the traffic's
``driver`` names the module of ``drivers/`` that sets the program up and
runs its timed loop, and ``limits/<cell>.json`` holds the limits of the
numbers its check compares. A per-layer metric is read by
``metrics/<name>.py::read(record)``. Adding a cell or a metric adds
files; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules no run may hold: JAX and the package the port was
#: made from (compared whole, the port's name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "dasemanticsegmentationaml_tpu")


def load_json(*parts) -> Any:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell's pieces and the run's arguments."""
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    chips: int
    #: ``time.time()`` when the process started (set-up runs from it)
    t0_wall: float
    #: a fault planted under the timed path (the checks' own tests)
    fault: Optional[str] = None


def cell(name: str, root: str = ROOT, overrides: Optional[dict] = None):
    """(the BENCHMARK.json entry, config, traffic, limits) of cell
    ``name``; ``overrides`` ({"traffic": {...}, "config": {...}}) replace
    parameters (small sizes for tests on the CPU)."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(root, conf["file"])
    traffic = load_json(HERE, "traffic", entry["traffic"] + ".json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    limits = load_json(HERE, "limits", name + ".json")
    return entry, config, traffic, limits


def driver(traffic: dict):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def reader(metric: str):
    """``metrics/<metric>.py``, loaded from its file (names hold dots)."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def checked(numbers: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """{name: {"value", "limit"}} of every number the cell compares."""
    return {k: {"value": numbers.get(k, math.nan), "limit": limits[k]["limit"]}
            for k in limits if not k.startswith("_")}


def is_correct(compared: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in compared.values())


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             chips: int, t0_wall: float, root: str = ROOT,
             overrides: Optional[dict] = None,
             fault: Optional[str] = None, keep_numbers: bool = False) -> dict:
    """The result line's object of one run (module docstring);
    ``keep_numbers``: with every number the driver worked out, compared or
    not, under ``numbers`` (the limits' readings)."""
    entry, config, traffic, limits = cell(name, root, overrides)
    run = Run(name, config, traffic, limits, int(seed), float(seconds),
              bool(trace), device, chips, t0_wall, fault)
    out = driver(traffic).run(run)
    bench = benchmark(root)
    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            value = reader(m["name"]).read(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if name in m.get("workloads", [name])}
    compared = checked(out["numbers"], limits)
    device_info = {"platform": ("gpu" if str(device).startswith("cuda")
                                else "cpu"),
                   "kind": out["device_kind"], "count": chips,
                   "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": is_correct(compared) and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if trace:
        rec = out["record"]
        per_step = lambda r: r["seconds"] / r["steps"] * 1e3  # noqa: E731
        print(f"ms a step: untraced window {per_step(rec['host'])!r}, "
              f"traced device alone {per_step(rec)!r}, traced with the "
              f"host {per_step(rec['host_record'])!r}",
              file=sys.stderr, flush=True)
        device_info["busy_s"] = out["busy_s"]
        device_info["window_s"] = out["window_s"]
        result["breakdown"] = out["breakdown"]
    if keep_numbers:
        result["numbers"] = out["numbers"]
    result["checked"] = compared
    return result


def setup_seconds(t0_wall: float) -> float:
    return time.time() - t0_wall
