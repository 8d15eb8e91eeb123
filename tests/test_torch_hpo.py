"""The port's HPO harness (``dasemanticsegmentationaml_tpu_torch/hpo/``)
against the JAX package's ``hpo/``, on the CPU.

* The tuner: the port's ``search.py`` is a copy of JAX's. The same
  ``SEARCH_SPACE``; with one seed and one sequence of results (a toy
  objective, 40 draws, seeds 0-4, with and without ``budget=10``, the
  results fed at once or two draws late) both tuners draw the same
  parameters and reach the same best. Then ``tests/test_hpo.py``'s tuner
  tests on the port's copy: bounds, the best tracked, annealing beats
  random search, the ``budget // 3`` cap, the gate on draws issued.
* One trial against JAX's: ``hpo.trial.main`` of each package, once per
  module, on the same 64 x 128 trees, seeded G and FC D ``.pth`` files
  and parameters (fp32, 3 epochs of 1 step, a validation an epoch). The
  same records (2 intermediate, 1 final), mIoUs within 1e-3 absolute (as
  ``tests/test_torch_multi_device_cli.py`` holds mIoU), each final the
  max of its intermediates.
* ``report_fn`` through ``cli.main``: once a validation, supervised and
  DA; over two spawned gloo ranks (``--num_devices 2 --cuda cpu``) in the
  calling process, once each, in order, nothing from rank 1.
* The trial command of ``experiment._trial_command`` as a process.
* The experiment runner with ``subprocess.run`` faked (as
  ``tests/test_hpo.py``): the fallback with a failing trial, concurrency
  2, the deadline, the NNI settings, a fake ``nni``'s branch and its port
  scan, auto-detection.

Each CLI run's directory is deleted once read.
"""

import json
import os
import random
import shutil
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from test_torch_da_cli import _seeded_d_pth
from test_torch_eval import H, W, _mk_cityscapes, _mk_gtav, _seeded_pth

from dasemanticsegmentationaml_tpu.hpo import search as jax_search
from dasemanticsegmentationaml_tpu.hpo import trial as jax_trial
from dasemanticsegmentationaml_tpu_torch import cli
from dasemanticsegmentationaml_tpu_torch.hpo import experiment as ex
from dasemanticsegmentationaml_tpu_torch.hpo import search, trial
from dasemanticsegmentationaml_tpu_torch.hpo.search import (SEARCH_SPACE,
                                                            AnnealTuner,
                                                            sample_space)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the trial's parameters (lr_D1 and weight_decay stay the CLI's defaults)
PARAMS = {"batch_size": 2, "lr": 1e-3, "num_epochs": 3, "lambda_adv1": 1e-3}
#: the bound on a reported mIoU, port against JAX
MIOU_TOL = 1e-3
#: seconds the spawned ranks' trial may take before the test fails
RANKS_TIMEOUT = 600


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """As tests/test_torch_da.py: torch on one CPU thread beside jaxlib."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the tuner --------------------------------------------------------

#: a point of the unit cube the toy objective peaks at
TARGET = dict(zip(SEARCH_SPACE, [0.23, 0.71, 0.11, 0.52, 0.88, 0.34]))


def _score(params):
    return -sum((search._to_unit(n, params[n]) - TARGET[n]) ** 2
                for n in SEARCH_SPACE)


def _sweep(module, seed, budget, lag, n=40):
    """``n`` draws of ``module``'s AnnealTuner on the toy objective, each
    result fed ``lag`` draws after its draw."""
    tuner = module.AnnealTuner(seed=seed, budget=budget)
    drawn, pending = [], []
    for _ in range(n):
        p = tuner.generate_parameters()
        drawn.append(p)
        pending.append(p)
        if len(pending) > lag:
            q = pending.pop(0)
            tuner.receive_trial_result(q, _score(q))
    for q in pending:
        tuner.receive_trial_result(q, _score(q))
    return drawn, tuner.best


def test_port_search_space_is_jax_search_space():
    assert SEARCH_SPACE == jax_search.SEARCH_SPACE
    assert SEARCH_SPACE is not jax_search.SEARCH_SPACE


@pytest.mark.parametrize("lag", [0, 2])
@pytest.mark.parametrize("budget", [None, 10])
@pytest.mark.parametrize("seed", range(5))
def test_port_tuner_draws_as_jax_tuner(seed, budget, lag):
    ours, our_best = _sweep(search, seed, budget, lag)
    theirs, their_best = _sweep(jax_search, seed, budget, lag)
    assert ours == theirs
    assert our_best == their_best


def test_port_sampler_within_bounds():
    rng = random.Random(0)
    for _ in range(50):
        p = sample_space(rng)
        assert 2 <= p["batch_size"] < 12
        assert 1e-4 <= p["lr"] <= 0.1
        assert 1e-6 <= p["lr_D1"] <= 1e-3
        assert 15 <= p["num_epochs"] < 50
        assert 1e-5 <= p["lambda_adv1"] <= 1e-3
        assert 1e-5 <= p["weight_decay"] <= 0.01


def test_port_tuner_tracks_best():
    tuner = AnnealTuner(seed=0)
    seen = []
    for i in range(8):
        p = tuner.generate_parameters()
        tuner.receive_trial_result(p, float(i % 3))
        seen.append(float(i % 3))
    assert tuner.best[1] == max(seen)


def test_port_tuner_beats_random_search():
    """At a matched budget of 40 and matched seeds, the annealer's best
    beats random sampling's on at least 4 of 5 seeds, and on average."""
    wins, anneal_bests, random_bests = 0, [], []
    for seed in range(5):
        _, (_, best) = _sweep(search, seed, None, 0)
        rng = random.Random(seed)
        rnd_best = max(_score(sample_space(rng)) for _ in range(40))
        anneal_bests.append(best)
        random_bests.append(rnd_best)
        wins += best > rnd_best
    assert wins >= 4, (wins, anneal_bests, random_bests)
    assert np.mean(anneal_bests) > np.mean(random_bests)


@pytest.mark.parametrize("budget,init_random", [(10, 3), (40, 10), (4, 2)])
def test_port_tuner_budget_caps_random_phase(budget, init_random):
    """The random phase is capped to budget // 3 (at least 2), so that a
    sweep of the reference's 10 trials still anneals."""
    tuner = AnnealTuner(seed=0, budget=budget)
    assert tuner.init_random == init_random
    for _ in range(budget):
        p = tuner.generate_parameters()
        tuner.receive_trial_result(p, _score(p))
    assert tuner.t < 1.0


def test_port_tuner_gate_counts_draws_issued(monkeypatch):
    """Past the random phase's draws, one result in hand is enough to
    exploit, however many are still out (seed 1: the 10% explore roll
    does not fire on the probed draw); with none, it samples."""
    calls = {"n": 0}
    real_sample = search.sample_space

    def counting_sample(rng):
        calls["n"] += 1
        return real_sample(rng)

    monkeypatch.setattr(search, "sample_space", counting_sample)
    tuner = search.AnnealTuner(seed=1, budget=10)
    issued = [tuner.generate_parameters() for _ in range(3)]
    assert calls["n"] == 3
    tuner.receive_trial_result(issued[0], 1.0)
    p4 = tuner.generate_parameters()
    assert tuner.issued == 4 and calls["n"] == 3
    assert set(p4) == set(SEARCH_SPACE)
    t2 = search.AnnealTuner(seed=1, budget=10)
    for _ in range(5):
        t2.generate_parameters()
    assert calls["n"] == 8


# ---- trials and the CLI -----------------------------------------------

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The DA trees of tests/test_torch_da_cli.py and its seeded G and FC D
    files."""
    base = tmp_path_factory.mktemp("hpo")
    paths = {name: str(base / name) for name in ("cs", "tgt", "gta")}
    _mk_cityscapes(paths["cs"], "val", n=2)
    _mk_cityscapes(paths["cs"], "train", n=4)   # the supervised run's
    _mk_cityscapes(paths["tgt"], "train", n=4)
    _mk_gtav(paths["gta"], n=4)
    paths["g"], paths["d"] = str(base / "g.pth"), str(base / "d.pth")
    _seeded_pth(paths["g"])
    _seeded_d_pth(paths["d"], "fc")
    paths["base"] = str(base)
    yield paths
    shutil.rmtree(str(base), ignore_errors=True)


def _cli_argv(trees, save):
    return ["--root", trees["cs"], "--root_source", trees["gta"],
            "--root_target", trees["tgt"], "--pretrain_path", trees["g"],
            "--d_pretrain_path", trees["d"],
            "--crop_height", str(H), "--crop_width", str(W),
            "--faithful_resize", "False", "--eval_batch_size", "2",
            "--validation_step", "1", "--checkpoint_step", "50",
            "--max_steps_per_epoch", "1", "--num_workers", "1",
            "--dtype", "float32", "--tensorboard", "False",
            "--save_model_path", save]


def _trial_argv(trees, name, params=PARAMS):
    """(argv of hpo.trial.main, its --nni_output, its run directory)."""
    run = os.path.join(trees["base"], name)
    out = run + ".jsonl"
    return (["--nni_params", json.dumps(params), "--nni_output", out]
            + _cli_argv(trees, run), out, run)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _run_trial(main, argv, out, run):
    miou = main(argv)
    shutil.rmtree(run, ignore_errors=True)
    return miou, _records(out)


@pytest.fixture(scope="module")
def jax_trial_run(trees):
    argv, out, run = _trial_argv(trees, "jax")
    return _run_trial(jax_trial.main, argv + ["--num_devices", "1"], out, run)


@pytest.fixture(scope="module")
def port_trial_run(trees):
    argv, out, run = _trial_argv(trees, "port")
    return _run_trial(trial.main, argv + ["--cuda", "cpu"], out, run)


def test_port_trial_records_as_jax_trial(jax_trial_run, port_trial_run):
    (want, want_recs), (got, got_recs) = jax_trial_run, port_trial_run
    print(f"port {got_recs}\nJAX {want_recs}")
    kinds = [r["type"] for r in got_recs]
    assert kinds == [r["type"] for r in want_recs]
    assert kinds == ["intermediate", "intermediate", "final"]
    values = [r["value"] for r in got_recs]
    np.testing.assert_allclose(values, [r["value"] for r in want_recs],
                               rtol=0, atol=MIOU_TOL)
    assert all(np.isfinite(values)) and 0.0 <= got <= 1.0


@pytest.mark.parametrize("side", ["port", "jax"])
def test_port_and_jax_trial_final_is_max_of_intermediates(
        side, jax_trial_run, port_trial_run):
    miou, recs = {"port": port_trial_run, "jax": jax_trial_run}[side]
    assert recs[-1]["value"] == max(r["value"] for r in recs[:-1]) == miou


def test_port_trial_forces_its_flags_after_the_passthrough():
    """The forced flags come after the passthrough, so they win (JAX
    trial.py:97-102); the reference's key names map onto the port's."""
    args = types.SimpleNamespace(nni_params=json.dumps(
        {"batch-size": 4, "learning_rate": 0.01, "learning_rate_D": 1e-4,
         "lambda_adv_target1": 2e-4, "num_epochs": 20.0,
         "weight_decay": 5e-4}), nni_output=None)
    params = trial.get_params(args)
    assert params == {"batch_size": 4, "lr": 0.01, "lr_D1": 1e-4,
                      "lambda_adv1": 2e-4, "num_epochs": 20.0,
                      "weight_decay": 5e-4}
    argv = trial.trial_args(["--depthwise", "True", "--d_head", "0"], params)
    parsed = cli.parse_args(argv)
    assert (parsed.domain_adaptation, parsed.depthwise, parsed.d_head,
            parsed.da_step_mode) == (True, False, 2, "combined")
    assert (parsed.batch_size, parsed.learning_rate, parsed.learning_rate_D,
            parsed.num_epochs, parsed.lambda_adv_target1,
            parsed.weight_decay) == (4, 0.01, 1e-4, 20, 2e-4, 5e-4)


@pytest.mark.parametrize("max_miou,miou,want", [
    (0.0, 0.5, 0.0), (None, 0.25, 0.25), (None, None, 0.0)])
def test_port_trial_final_key_checks(tmp_path, monkeypatch, max_miou, miou,
                                     want):
    """A max_miou of 0.0 is the final result; it does not fall through to
    the final eval's miou (JAX trial.py:122-131)."""
    result = {k: v for k, v in (("max_miou", max_miou), ("miou", miou))
              if v is not None}
    monkeypatch.setattr(cli, "main", lambda argv, report_fn=None: result)
    out = str(tmp_path / "r.jsonl")
    assert trial.main(["--nni_params", "{}", "--nni_output", out]) == want
    assert _records(out) == [{"type": "final", "value": want}]


@pytest.mark.parametrize("mode", ["supervised", "da"])
def test_port_cli_main_reports_each_validation(trees, mode):
    """``cli.main(argv, report_fn=...)``: once a validation, with the
    epoch and that validation's mIoU, before the final evaluation."""
    run = os.path.join(trees["base"], f"report_{mode}")
    argv = _cli_argv(trees, run) + ["--batch_size", "2", "--num_epochs", "3",
                                    "--cuda", "cpu"]
    if mode == "da":
        argv += ["--domain_adaptation", "True"]
    reports = []
    res = cli.main(argv, report_fn=lambda epoch, miou:
                   reports.append((epoch, miou)))
    shutil.rmtree(run, ignore_errors=True)
    assert [epoch for epoch, _ in reports] == [1, 2]
    assert all(isinstance(m, float) and 0.0 <= m <= 1.0 for _, m in reports)
    assert max(m for _, m in reports) == res["max_miou"]


def test_port_trial_over_spawned_ranks_reports_in_caller(trees, monkeypatch):
    """``--num_devices 2 --cuda cpu``: rank 0's reports reach the reporter
    in this process, once a validation, in order; rank 1 reports nothing
    (a report made in a rank would write a record this process did not
    see)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    seen = []
    call = trial._Reporter.__call__

    def recording(self, epoch, miou):
        seen.append((os.getpid(), epoch, miou))
        call(self, epoch, miou)

    monkeypatch.setattr(trial._Reporter, "__call__", recording)
    argv, out, run = _trial_argv(trees, "ranks")
    box = {}
    thread = threading.Thread(target=lambda: box.update(
        miou=trial.main(argv + ["--num_devices", "2", "--cuda", "cpu"])),
        daemon=True)
    thread.start()
    thread.join(RANKS_TIMEOUT)
    assert not thread.is_alive(), "the ranks ran past their time"
    shutil.rmtree(run, ignore_errors=True)
    recs = _records(out)
    assert [e for _, e, _ in seen] == [1, 2]
    assert {pid for pid, _, _ in seen} == {os.getpid()}
    assert [r["type"] for r in recs] == ["intermediate"] * 2 + ["final"]
    assert [r["value"] for r in recs[:-1]] == [m for _, _, m in seen]
    assert recs[-1]["value"] == max(m for _, _, m in seen) == box["miou"]


def test_port_trial_command_runs_as_a_process(trees):
    """The experiment's own trial command, in a fresh interpreter."""
    params = dict(PARAMS, num_epochs=2)
    argv, out, run = _trial_argv(trees, "process", params)
    cmd = ex._trial_command(argv + ["--cuda", "cpu"])
    assert cmd[1:3] == ["-m", "dasemanticsegmentationaml_tpu_torch.hpo.trial"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=trees["base"], env=env,
                          capture_output=True, text=True, timeout=300)
    shutil.rmtree(run, ignore_errors=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    recs = _records(out)
    assert [r["type"] for r in recs] == ["intermediate", "final"]
    assert recs[1]["value"] == recs[0]["value"]


# ---- the experiment runner --------------------------------------------

def _final_record(cmd, value):
    with open(cmd[cmd.index("--nni_output") + 1], "w") as f:
        f.write(json.dumps({"type": "final", "value": value}) + "\n")


def test_port_experiment_sequential_fallback(tmp_path, monkeypatch):
    """The built-in runner: the tuner's parameters a trial, the trial's
    final record read, a failing trial scored 0 without ending the sweep,
    the best reported, one JSONL line a trial."""
    seen = []

    def fake_run(cmd, capture_output=True, text=True, timeout=None):
        assert cmd[:3] == [sys.executable, "-m",
                           "dasemanticsegmentationaml_tpu_torch.hpo.trial"]
        seen.append(json.loads(cmd[cmd.index("--nni_params") + 1]))
        if len(seen) == 2:
            return subprocess.CompletedProcess(cmd, 1, "", "boom")
        _final_record(cmd, 0.1 * len(seen))
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(ex.subprocess, "run", fake_run)
    res = ex.run_experiment(static_args=["--root", "x"], max_trials=3,
                            results_path=str(tmp_path / "res.jsonl"),
                            use_nni=False)
    assert res["nni"] is False and len(res["trials"]) == 3 == len(seen)
    for p in seen:
        assert 2 <= p["batch_size"] <= 12 and 1e-4 <= p["lr"] <= 0.1
    assert res["trials"][1]["miou"] == 0.0
    assert res["best_miou"] == pytest.approx(0.3)
    assert [r["id"] for r in _records(tmp_path / "res.jsonl")] == [0, 1, 2]


def test_port_experiment_runs_two_trials_at_once(tmp_path, monkeypatch):
    lock = threading.Lock()
    inflight = {"now": 0, "max": 0, "n": 0}

    def fake_run(cmd, capture_output=True, text=True, timeout=None):
        with lock:
            inflight["now"] += 1
            inflight["max"] = max(inflight["max"], inflight["now"])
            inflight["n"] += 1
            n = inflight["n"]
        time.sleep(0.1)
        _final_record(cmd, 0.1 * n)
        with lock:
            inflight["now"] -= 1
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(ex.subprocess, "run", fake_run)
    res = ex.run_experiment(static_args=[], max_trials=4, concurrency=2,
                            results_path=str(tmp_path / "res.jsonl"),
                            use_nni=False)
    assert len(res["trials"]) == 4 and inflight["max"] == 2
    assert res["best_miou"] == pytest.approx(0.4)


def test_port_experiment_kills_trials_at_the_deadline(tmp_path, monkeypatch):
    monkeypatch.setattr(ex, "_trial_command", lambda args: [
        sys.executable, "-c", "import time; time.sleep(120)"])
    t0 = time.time()
    res = ex.run_experiment(static_args=[], max_trials=2, concurrency=1,
                            max_hours=2.0 / 3600,
                            results_path=str(tmp_path / "res.jsonl"),
                            use_nni=False)
    assert time.time() - t0 < 60
    assert res["trials"]
    assert all(t["timed_out"] and t["miou"] == 0.0 for t in res["trials"])


def test_port_experiment_nni_config_names_the_port_trial():
    cfg = ex.build_nni_experiment_config(
        ["--aug_type", "CS-HF", "--root_source", "/data/gta"],
        max_trials=10, concurrency=1, max_hours=12.0, code_dir="/tmp/x")
    assert cfg["search_space"] is SEARCH_SPACE
    assert (cfg["tuner_name"], cfg["tuner_class_args"]) == (
        "Anneal", {"optimize_mode": "maximize"})
    assert (cfg["max_trial_number"], cfg["trial_concurrency"],
            cfg["max_experiment_duration"], cfg["trial_code_directory"]) == (
        10, 1, "12.0h", "/tmp/x")
    assert cfg["ports"] == list(range(8030, 8090))
    assert "--aug_type CS-HF" in cfg["trial_command"]
    assert (" -m dasemanticsegmentationaml_tpu_torch.hpo.trial "
            in cfg["trial_command"])


def _fake_nni(monkeypatch, fail_ports=()):
    """A fake ``nni`` and ``nni.experiment`` in sys.modules (restored by
    monkeypatch), whose Experiment records its settings and ports."""
    created = []

    class FakeExperiment:
        def __init__(self, mode):
            self.mode = mode
            self.config = types.SimpleNamespace(
                tuner=types.SimpleNamespace(name=None, class_args=None))
            self.run_calls = []
            created.append(self)

        def run(self, port):
            self.run_calls.append(port)
            if port in fail_ports:
                raise OSError(f"port {port} in use")
            return True

    nni_mod = types.ModuleType("nni")
    exp_mod = types.ModuleType("nni.experiment")
    exp_mod.Experiment = FakeExperiment
    nni_mod.experiment = exp_mod
    monkeypatch.setitem(sys.modules, "nni", nni_mod)
    monkeypatch.setitem(sys.modules, "nni.experiment", exp_mod)
    return created


def test_port_experiment_fake_nni_branch(monkeypatch):
    created = _fake_nni(monkeypatch)
    res = ex.run_experiment(static_args=["--aug_type", "CS-HF"],
                            max_trials=7, concurrency=2, max_hours=3.0,
                            use_nni=True)
    assert res == {"nni": True, "port": 8030}
    (exp,) = created
    assert exp.mode == "local" and exp.run_calls == [8030]
    assert (exp.config.tuner.name, exp.config.tuner.class_args) == (
        "Anneal", {"optimize_mode": "maximize"})
    assert (exp.config.max_trial_number, exp.config.trial_concurrency,
            exp.config.max_experiment_duration) == (7, 2, "3.0h")
    assert exp.config.search_space is SEARCH_SPACE
    assert "--aug_type CS-HF" in exp.config.trial_command
    assert ("dasemanticsegmentationaml_tpu_torch.hpo.trial"
            in exp.config.trial_command)


@pytest.mark.parametrize("busy,port", [({8030, 8031}, 8032),
                                       (set(range(8030, 8090)), None)])
def test_port_experiment_fake_nni_port_scan(monkeypatch, busy, port):
    """Busy ports fall through to the next of 8030-8089; with all busy the
    last error is raised, not swallowed."""
    created = _fake_nni(monkeypatch, fail_ports=busy)
    if port is None:
        with pytest.raises(RuntimeError, match="8030-8089.*port 8089 in use"):
            ex.run_experiment(static_args=[], use_nni=True)
    else:
        assert ex.run_experiment(static_args=[], use_nni=True) == {
            "nni": True, "port": port}
    (exp,) = created
    assert exp.run_calls == list(range(8030, (port or 8089) + 1))


def test_port_experiment_auto_detects_nni(tmp_path, monkeypatch):
    """use_nni=None: the built-in runner without nni, the NNI branch with
    it."""
    assert not ex._nni_available()
    monkeypatch.setattr(ex.subprocess, "run", lambda cmd, **kw: (
        _final_record(cmd, 0.5), subprocess.CompletedProcess(
            cmd, 0, "", ""))[1])
    res = ex.run_experiment(static_args=[], max_trials=1,
                            results_path=str(tmp_path / "res.jsonl"))
    assert res["nni"] is False and res["best_miou"] == 0.5
    _fake_nni(monkeypatch)
    assert ex._nni_available()
    assert ex.run_experiment(static_args=[]) == {"nni": True, "port": 8030}
