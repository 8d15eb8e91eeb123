"""The entry point's refusals, the result line's keys, and what a run may
import."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
RUN = [sys.executable, "portbench/run.py", "--seed", "3", "--seconds", "1",
       "--trace", "0"]


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = subprocess.run(RUN + ["--workload", CELLS[0]], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_run_refuses_without_the_port(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in harness.benchmark()["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(RUN + ["--workload", CELLS[0]], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


#: what a run imports: the entry, the harness, each driver, the readers
IMPORTS = """
import sys, json
sys.path.insert(0, {root!r})
import portbench.run, portbench.harness as h, portbench.calibrate
import portbench.drivers.{driver}
for m in h.benchmark()["per_layer"]:
    h.reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_imports_no_jax(cell):
    driver = harness.cell(cell)[2]["driver"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", IMPORTS.format(
        root=ROOT, driver=driver)], capture_output=True, text=True,
        timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_a_run_holds_no_jax_after_its_window():
    """The run's own check, on the modules of a driver's whole run."""
    code = f"""
import sys, time
sys.path.insert(0, {ROOT!r})
from portbench import harness
harness.run_cell({CELLS[0]!r}, 3, 0.5, True, "cpu", 1, time.time(),
                 overrides={{"traffic": {{"batch": 2, "hw": [64, 128],
                  "pool": 2, "warmup_steps": 1, "trace_steps": 1}}}})
print(harness.forbidden_modules())
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_port():
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import portbench.reference.steps, portbench.reference.model, portbench.check
import portbench.roofline, portbench.flops, portbench.inputs
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    top = proc.stdout.strip().splitlines()[-1]
    assert "dasemanticsegmentationaml_tpu" not in top
    assert "'jax'" not in top


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("dasemanticsegmentationaml_tpu_torch", sys)
    assert "dasemanticsegmentationaml_tpu" not in harness.forbidden_modules()
