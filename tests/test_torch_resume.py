"""``--resume`` and the full train state of the port, on the CPU.

A resumed run must be the straight run: the port's supervised CLI, with
``--iter_size 1`` and with ``--iter_size 2`` at 3 steps an epoch (so the
epoch-2 checkpoint falls inside an accumulation), and its DA CLI with the
FC and the DW+BN discriminator, each run straight and run again with a
death at the start of its last epoch (``Loader.set_epoch`` raises, after
the previous epoch's checkpoints) and a ``--resume <save>/state``; the
per-epoch losses and the final states (model, optimizer, accumulator)
must be bit-identical. The dying run has the straight run's flags: the
poly LR depends on ``--num_epochs``, so a shorter run would train at
other rates. Against the JAX CLI: both run 2 epochs and ``--resume`` to 4
(one step an epoch) from one seeded ``.pth``; start epochs equal,
per-epoch losses within rtol 1e-3 (PERF.md §2's CLI bound), at
``--learning_rate 1e-3`` as tests/test_torch_aug_cli.py runs: at the
default 0.01 two straight 4-epoch runs without any resume already differ
by 6e-4 at epoch 2 and 2.6e-3 at epoch 3 from these weights (fp32
rounding compounding over steps, ROADMAP.md Queue 3's gaps). Then the
checkpoint function's aliases and marker, the JAX ``SystemExit`` text for
a missing alias, and a leftover temporary marker.

Adds about 90 s alone on the CPU (the JAX CLI's two runs, 55 s of it).
"""

import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

from test_torch_eval import H, W, _mk_cityscapes, _mk_gtav, _seeded_pth

from dasemanticsegmentationaml_tpu import cli as jax_cli
from dasemanticsegmentationaml_tpu_torch import cli
from dasemanticsegmentationaml_tpu_torch.data.pipeline import Loader
from dasemanticsegmentationaml_tpu_torch.train.optim import (
    GradientAccumulator, make_optimizer)
from dasemanticsegmentationaml_tpu_torch.utils import state_io
from dasemanticsegmentationaml_tpu_torch.utils.checkpoint import (
    make_checkpoint_fn)

COMMON = ["--crop_height", str(H), "--crop_width", str(W),
          "--faithful_resize", "False", "--batch_size", "2",
          "--eval_batch_size", "2", "--validation_step", "1",
          "--checkpoint_step", "1", "--num_workers", "1",
          "--dtype", "float32", "--tensorboard", "False"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one CPU thread, as tests/test_torch_da.py runs it. The
    test command runs six workers on a few cores; there, on all of its
    intra-op threads, this file's small steps ran up to 100 times slower
    than in one process (threads waiting at every op's barrier)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Died(Exception):
    pass


def _run(argv, monkeypatch, die_at=None):
    """cli.main(argv); with ``die_at``, the run dies as epoch ``die_at``
    starts (after every checkpoint of the epoch before)."""
    if die_at is not None:
        set_epoch = Loader.set_epoch

        def dying(self, epoch):
            if epoch == die_at:
                raise _Died(epoch)
            set_epoch(self, epoch)

        monkeypatch.setattr(Loader, "set_epoch", dying)
    try:
        return cli.main(argv)
    except _Died:
        return None
    finally:
        monkeypatch.undo()


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _assert_same(a, b, where=""):
    """Nested dicts / lists of tensors and plain values, bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _straight_and_resumed(tmp_path, argv, die_at, monkeypatch, names):
    """The straight run and the died + resumed one: their logs and their
    final states ``names`` under ``<save>/state``; and the 'latest' state
    the dying run left."""
    out = {}
    for kind in ("straight", "resumed"):
        save = str(tmp_path / kind)
        log = str(tmp_path / f"{kind}.jsonl")
        run = argv + ["--save_model_path", save, "--jsonl_log", log]
        if kind == "resumed":
            assert _run(run, monkeypatch, die_at=die_at) is None
            assert state_io.latest_epoch_marker(
                os.path.join(save, "state")) == die_at - 1
            out["died"] = state_io.restore_train_state(
                os.path.join(save, "state"), "latest")
            run = run + ["--resume", os.path.join(save, "state")]
        res = _run(run, monkeypatch)
        states = {n: state_io.restore_train_state(
            os.path.join(save, "state"), n) for n in names}
        out[kind] = (res, _log(log), states)
        shutil.rmtree(save)  # 0.1-0.3 GB of states and weights a run
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("resume")
    paths = {name: str(base / name) for name in ("cs", "gta")}
    _mk_cityscapes(paths["cs"], "train", n=6)
    _mk_cityscapes(paths["cs"], "val", n=2)
    _mk_gtav(paths["gta"], n=4)
    paths["g"] = str(base / "g.pth")
    _seeded_pth(paths["g"])
    return paths


@pytest.mark.parametrize("iter_size", [1, 2])
def test_supervised_resume_is_the_straight_run(trees, tmp_path, monkeypatch,
                                               iter_size):
    """4 epochs of 3 steps, straight against died at epoch 3 + resumed;
    with --iter_size 2 the epoch-2 state holds mini-step 1 of an
    accumulation (9 mini-steps)."""
    argv = COMMON + ["--root", trees["cs"], "--cuda", "cpu",
                     "--num_epochs", "4", "--max_steps_per_epoch", "3",
                     "--iter_size", str(iter_size)]
    runs = _straight_and_resumed(tmp_path, argv, 3, monkeypatch,
                                 ["latest"])
    (res_a, log_a, st_a), (res_b, log_b, st_b) = (runs["straight"],
                                                  runs["resumed"])
    assert [r["epoch"] for r in log_b] == [0, 1, 2, 3]
    assert [r["loss"] for r in log_a] == [r["loss"] for r in log_b]
    _assert_same(st_a, st_b)
    assert st_a["latest"]["epoch"] == 3
    assert res_a["miou"] == res_b["miou"]
    died = runs["died"]["accumulator"]
    if iter_size == 2:
        # 9 mini-steps at the epoch-2 checkpoint, 12 at the end
        assert died["mini_step"] == 1 and died["every_k"] == 2
        assert any(a.abs().max() > 0 for a in died["acc"])
        assert st_a["latest"]["accumulator"]["mini_step"] == 0
    else:
        assert died is None and st_a["latest"]["accumulator"] is None
    # num_batches_tracked is in the state (the .pth leaves it out)
    tracked = [k for k in st_a["latest"]["model"]
               if k.endswith("num_batches_tracked")]
    assert tracked and int(st_a["latest"]["model"][tracked[0]]) == 12


@pytest.mark.parametrize("d_flags", [
    ["--depthwise", "False"],
    ["--depthwise", "True", "--batch_norm", "True"]], ids=["fc", "dwbn"])
def test_da_resume_is_the_straight_run(trees, tmp_path, monkeypatch,
                                       d_flags):
    """3 DA epochs of 2 steps, straight against died at epoch 2 +
    resumed: G, D and both optimizers (D's Adam step counters included)
    bit-identical, and the per-epoch losses too."""
    argv = COMMON + ["--domain_adaptation", "True", "--root", trees["cs"],
                     "--root_source", trees["gta"],
                     "--root_target", trees["cs"], "--cuda", "cpu",
                     "--num_epochs", "3", "--max_steps_per_epoch", "2",
                     *d_flags]
    runs = _straight_and_resumed(tmp_path, argv, 2, monkeypatch,
                                 ["latest", "latest_D1", "GTA5_1",
                                  "GTA5_1_D1"])
    (_, log_a, st_a), (_, log_b, st_b) = (runs["straight"],
                                          runs["resumed"])
    assert [r["epoch"] for r in log_b] == [0, 1, 2]
    for key in ("loss_seg", "loss_adv"):
        assert [r[key] for r in log_a] == [r[key] for r in log_b]
    _assert_same(st_a, st_b)
    steps = st_a["latest_D1"]["optimizer"]["state"][0]["step"]
    assert steps.device.type == "cpu" and float(steps) == 3 * 2 * 2
    _assert_same(st_a["latest"]["model"], st_a["GTA5_1"]["model"])


@pytest.fixture(scope="module")
def jax_and_port_resumed(trees, tmp_path_factory):
    """Each CLI: 2 epochs of one step, then --resume to 4; per-epoch
    losses from --jsonl_log, which both append to."""
    base = tmp_path_factory.mktemp("resume_cli")
    argv = COMMON + ["--root", trees["cs"], "--pretrain_path", trees["g"],
                     "--max_steps_per_epoch", "1", "--learning_rate", "1e-3"]
    out = {}
    for name, main, extra, state in (
            ("jax", jax_cli.main, ["--num_devices", "1"], "orbax"),
            ("port", cli.main, ["--cuda", "cpu"], "state")):
        save = str(base / name)
        log = str(base / f"{name}.jsonl")
        run = argv + extra + ["--save_model_path", save, "--jsonl_log", log]
        main(run + ["--num_epochs", "2"])
        res = main(run + ["--num_epochs", "4",
                          "--resume", os.path.join(save, state)])
        out[name] = (res, _log(log))
        shutil.rmtree(save)
    return out


def test_resumed_cli_matches_jax(jax_and_port_resumed):
    (want, want_log), (got, got_log) = (jax_and_port_resumed["jax"],
                                        jax_and_port_resumed["port"])
    assert [r["epoch"] for r in got_log] == [r["epoch"] for r in want_log] \
        == [0, 1, 2, 3]
    np.testing.assert_allclose([r["loss"] for r in got_log],
                               [r["loss"] for r in want_log], rtol=1e-3)
    assert 0.0 <= got["miou"] <= 1.0 and np.isfinite(got["miou"])


def _tiny(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                                torch.nn.BatchNorm2d(4))
    opt = make_optimizer("sgd", model.parameters(), 0.01, momentum=0.9,
                         weight_decay=1e-4)
    model(torch.randn(2, 3, 8, 8)).sum().backward()
    opt.step()
    return model, opt


@pytest.mark.parametrize("name,model,alias", [
    ("latest", None, "latest"), ("best", None, "latest"),
    ("GTA5_1", None, "latest"), ("GTA5_1_D1", "discriminator", "latest_D1"),
    ("best_D1", "discriminator", "latest_D1")])
def test_checkpoint_writes_the_alias_and_the_marker(tmp_path, name, model,
                                                    alias):
    """JAX cli.py:116-123: every save but the alias's own also writes the
    alias; a given epoch moves the marker (so a 'best' save moves
    'latest' and EPOCH)."""
    net, opt = _tiny()
    ckpt = make_checkpoint_fn(str(tmp_path))
    ckpt(net, name, optimizer=opt, model=model, epoch=5)
    state_dir = str(tmp_path / "state")
    assert sorted(os.listdir(state_dir)) == sorted(
        {f"{name}.pt", f"{alias}.pt", "EPOCH"})
    # the alias is the same file, not a second write of it
    assert os.path.samefile(state_io.state_path(state_dir, name),
                            state_io.state_path(state_dir, alias))
    assert state_io.latest_epoch_marker(state_dir) == 5
    assert os.path.exists(tmp_path / f"{name}.pth")
    saved = state_io.restore_train_state(state_dir, alias)
    _assert_same(saved, state_io.restore_train_state(state_dir, name))
    _assert_same(saved["model"], net.state_dict())
    _assert_same(saved["optimizer"], opt.state_dict())
    assert saved["epoch"] == 5 and saved["accumulator"] is None
    # without an epoch the marker stays where it was
    ckpt(net, name, optimizer=opt, model=model)
    assert state_io.latest_epoch_marker(state_dir) == 5


def test_alias_is_a_copy_where_hard_links_fail(tmp_path, monkeypatch):
    """A file system without hard links gets a copy under the alias."""
    def no_link(*a, **k):
        raise OSError("hard links not supported")

    monkeypatch.setattr(os, "link", no_link)
    net, opt = _tiny()
    make_checkpoint_fn(str(tmp_path))(net, "best", optimizer=opt, epoch=1)
    state_dir = str(tmp_path / "state")
    assert not os.path.samefile(state_io.state_path(state_dir, "best"),
                                state_io.state_path(state_dir, "latest"))
    _assert_same(state_io.restore_train_state(state_dir, "latest"),
                 state_io.restore_train_state(state_dir, "best"))
    assert sorted(os.listdir(state_dir)) == ["EPOCH", "best.pt",
                                             "latest.pt"]


@pytest.mark.parametrize("layout", ["absent", "empty", "other_state"])
def test_missing_alias_stops_with_the_jax_message(tmp_path, layout):
    """The port's SystemExit names the same alias, directory and found
    states as JAX cli.py:138-145 does for its orbax trees."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    if layout != "absent":
        os.makedirs(port_dir)
        os.makedirs(jax_dir)
    if layout == "other_state":
        state_io.save_train_state(port_dir, "best", {"x": 1})
        os.makedirs(os.path.join(jax_dir, "best"))
    messages = []
    for resume, fn in ((jax_dir, lambda a: jax_cli.maybe_resume(a, None)),
                       (port_dir, lambda a: cli.maybe_resume(a, None, None))):
        args = types.SimpleNamespace(resume=resume, epoch_start_i=0)
        with pytest.raises(SystemExit) as err:
            fn(args)
        messages.append(str(err.value).replace(resume, "<dir>"))
    assert messages[0] == messages[1]
    assert "no 'latest' state under <dir>" in messages[1]
    assert "the run died before its first checkpoint epoch" in messages[1]


def test_leftover_marker_and_state_temporaries_do_not_break_resume(tmp_path):
    """A run that died inside write_epoch_marker or save_train_state
    leaves '.EPOCH.tmp.<pid>' / '.latest.pt.tmp.<pid>' behind; resume
    reads EPOCH and latest.pt and nothing else."""
    net, opt = _tiny()
    acc = GradientAccumulator(opt, 2)
    ckpt = make_checkpoint_fn(str(tmp_path))
    ckpt(net, "latest", optimizer=opt, accumulator=acc, epoch=2)
    state_dir = str(tmp_path / "state")
    with open(os.path.join(state_dir, ".EPOCH.tmp.99999"), "w") as f:
        f.write("")
    with open(os.path.join(state_dir, ".latest.pt.tmp.99999"), "wb") as f:
        f.write(b"PK\x03\x04 half a zip")
    fresh, fresh_opt = _tiny(seed=1)
    fresh_acc = GradientAccumulator(fresh_opt, 2)
    args = types.SimpleNamespace(resume=state_dir, epoch_start_i=0)
    assert cli.maybe_resume(args, fresh, fresh_opt, fresh_acc) == 3
    _assert_same(fresh.state_dict(), net.state_dict())
    _assert_same(fresh_opt.state_dict(), opt.state_dict())
    _assert_same(fresh_acc.state_dict(), acc.state_dict())
    # an accumulation saved by --iter_size 2 does not resume under 1
    with pytest.raises(SystemExit, match="saved with --iter_size 2"):
        cli.maybe_resume(args, fresh, fresh_opt, None)
