"""``kernel_load_s.train``: the port's own counter of the seconds spent
building and loading its kernels, and nothing against a port that keeps
no such counter (the commit before it)."""

import time

import pytest

from dasemanticsegmentationaml_tpu_torch.utils import logging_util
from portbench import harness
from portbench.tests.conftest import SMALL

NAME = "kernel_load_s.train"


def test_reads_the_ports_counter(monkeypatch, capsys):
    monkeypatch.setattr(logging_util, "snapshot", lambda: {
        "kernels.load_s": 11.5, "kernels.builds.fused_ce": 1,
        "fused_ce.FWD_LAUNCHES": 3})
    assert harness.reader(NAME).read({"kind": "train"}) == 11.5
    assert "{'fused_ce': 1}" in capsys.readouterr().err


def test_reads_load_s_as_the_port_counts_it():
    # no card here: nothing loaded in this process, or what was
    want = logging_util.snapshot()["kernels.load_s"]
    assert harness.reader(NAME).read({"kind": "train"}) == want


@pytest.mark.parametrize("kind", ["another", None])
def test_another_kind_reads_nothing(kind):
    assert harness.reader(NAME).read({"kind": kind}) is None


def test_without_the_counters_a_traced_run_leaves_it_out(monkeypatch):
    """Against a port without ``snapshot`` the traced run completes and
    reports every other per-layer metric it reported with it (fp32, which
    is correct on the CPU as on the card)."""
    def traced():
        return harness.run_cell("train_b16", 2**31 + 11, 0.3, True, "cpu", 1,
                                time.time(),
                                overrides={"traffic": SMALL["train_b16"],
                                           "config": {"dtype": "float32"}})

    with_counters = traced()
    monkeypatch.delattr(logging_util, "snapshot")
    without = traced()
    assert NAME in with_counters["metrics"] and NAME not in without["metrics"]
    assert set(with_counters["metrics"]) - {NAME} == set(without["metrics"])
    assert without["correct"] and with_counters["correct"]
