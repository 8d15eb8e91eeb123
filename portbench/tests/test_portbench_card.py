"""On the card: each one-card cell at its own size for a short window,
through ``run.py`` as the benchmark's check runs it. Skips without one."""

import json
import subprocess
import sys

import pytest

from portbench import harness

ONE_CARD = [w["name"] for w in harness.benchmark()["workloads"]
            if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, cell, trace):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 5), "--seconds", "2", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checked"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for name, m in result["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < m["value"] <= 100
