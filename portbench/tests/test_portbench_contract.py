"""``BENCHMARK.json`` and the files it names: the keys, names, units and
limits the benchmark's contract sets, and every piece found by name."""

import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == KEYS
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32 and all(map(line, BENCH["command"]))
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        data = harness.load_json(ROOT, c["file"])
        assert data["reduced"] == c["reduced"] == []
        assert "assumed" in data and data["source"]


def test_workloads_and_their_pieces():
    ws = BENCH["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    four = [w for w in ws if w["chips"] == 4]
    assert len(four) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        entry, config, traffic, limits = harness.cell(w["name"])
        assert entry is not None and config and limits
        assert harness.driver(traffic).run
        assert all("limit" in v for k, v in limits.items()
                   if not k.startswith("_"))


def metric_ok(m, extra=()):
    assert set(m) <= {"name", "unit", "better", "source", "workloads",
                      *extra}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


def test_end_to_end():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        metric_ok(m, ("bound",))
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in BENCH["workloads"]]
    for c in cells:
        mine = [m["name"] for m in e2e if c in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2


def test_per_layer_and_readers():
    pl = BENCH["per_layer"]
    assert 1 <= len(pl) <= 128
    names = [m["name"] for m in BENCH["end_to_end"]] + [m["name"] for m in pl]
    assert len(set(names)) == len(names)
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells) for m in BENCH["end_to_end"]}
    layers = {}
    for m in pl:
        metric_ok(m, ("layer", "moves"))
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]])
        if m["name"].endswith("_roofline") or "mfu" in m["name"] \
                or "roofline." in m["name"]:
            assert m["unit"] == "%"
        assert callable(harness.reader(m["name"]).read)
        layers.setdefault(m["layer"], set()).add(m["name"])
    for c in cells:
        assert any(c in m["workloads"] for m in pl)


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for p in BENCH["paths"] for d, _, fs in os.walk(os.path.join(ROOT, p))
    for f in fs if "__pycache__" not in d))
def test_file_names(path):
    assert PATH.match(path)


def test_run_seconds_fit_a_full_check():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
