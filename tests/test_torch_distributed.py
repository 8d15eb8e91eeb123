"""The port's data-parallel runs across ranks against the JAX package, on
the CPU: the process-sharded loader, eval's exact count sums, and the CLI
at ``--num_devices 2 --cuda cpu`` (two spawned gloo ranks) against the
JAX CLI at ``--num_devices 2`` (two of the virtual CPU devices
``tests/conftest.py`` makes).

The CLI runs train BiSeNet-STDC813 from one ``.pth`` of seeded weights on
synthetic 64 x 128 trees, fp32, one step an epoch at ``--learning_rate
1e-3`` (PERF.md §2: at 0.01 fp32 rounding parts straight runs of both
CLIs within four steps), supervised with ``--sync_bn True`` (3 epochs)
and ``False`` (2 epochs, batch 4: per-replica BN needs two rows a rank),
and DA (FC D, 2 epochs). Bounds (PERF.md §2): per-epoch loss rtol 1e-3
(DA ``loss_D1`` 5e-3), mIoU |Δ| <= 1e-3; only rank 0 logs and writes,
and each side's ``.pth`` loads into the other. The sync run as two OS
processes (``--num_processes 2 --process_id r --coordinator_address
file://...``) equals the ``--num_devices 2`` run bit for bit, and so does
a two-process run that dies as epoch 2 starts and is resumed at world 2.
Torch runs on one thread in every process (``OMP_NUM_THREADS=1``); every
run over ranks is bounded by ``RUN_TIMEOUT`` (a hung rank is killed and
fails its test); each run's directory is deleted once read.
"""

import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import threading
import uuid

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_eval import H, W, _mk_cityscapes, _mk_gtav, _seeded_pth
from test_torch_da_cli import _seeded_d_pth
from torch_ranks import counts_above_int32, run_ranks, sharded_eval

from dasemanticsegmentationaml_tpu import cli as jax_cli
from dasemanticsegmentationaml_tpu.data.pipeline import Loader as JaxLoader
from dasemanticsegmentationaml_tpu.models.bisenet import BiSeNet as JaxBiSeNet
from dasemanticsegmentationaml_tpu.utils import torch_io
from dasemanticsegmentationaml_tpu_torch import cli
from dasemanticsegmentationaml_tpu_torch.data.pipeline import (
    Loader, prepare_batch)
from dasemanticsegmentationaml_tpu_torch.data.augment import batch_generator
from dasemanticsegmentationaml_tpu_torch.models.bisenet import BiSeNet
from dasemanticsegmentationaml_tpu_torch.train.evaluate import (
    eval_counts, evaluate)
from dasemanticsegmentationaml_tpu_torch.utils.weights import (
    load_reference_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a CLI run over two ranks may take
RUN_TIMEOUT = 300


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    """torch on one thread here and in every rank (spawned ranks inherit
    the environment), as tests/test_torch_da.py runs it."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Indexed:
    """Sample i is an image and a label filled with i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((2, 3, 3), i, np.uint8), np.full((2, 3), i, np.uint8))


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("count", [2, 4])
def test_loader_process_slices_match_jax(shuffle, count):
    """Every rank's batches are JAX ``Loader``'s for that rank, over two
    epochs, and the ranks' slices tile the one-process batches."""
    ds = _Indexed(19)
    for epoch in range(2):
        whole = Loader(ds, 8, shuffle=shuffle, seed=3, drop_last=True,
                       num_workers=1)
        whole.set_epoch(epoch)
        whole = [b[0][:, 0, 0, 0].numpy() for b in whole]
        parts = []
        for pid in range(count):
            ours = Loader(ds, 8, shuffle=shuffle, seed=3, drop_last=True,
                          num_workers=2, process_id=pid,
                          process_count=count)
            theirs = JaxLoader(ds, 8, shuffle=shuffle, seed=3,
                               num_workers=2, process_id=pid,
                               process_count=count)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got = [(i.numpy(), l.numpy()) for i, l in ours]
            want = list(theirs)
            assert len(got) == len(want) == len(ours) == 2
            for (gi, gl), (wi, wl) in zip(got, want):
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gl, wl)
            parts.append([g[0][:, 0, 0, 0] for g in got])
        for b, batch in enumerate(whole):
            np.testing.assert_array_equal(
                np.concatenate([p[b] for p in parts]), batch)


def test_loader_refuses_ragged_process_slices():
    """JAX pipeline.py:145-152's refusals."""
    with pytest.raises(ValueError, match="not divisible by process_count"):
        Loader(_Indexed(8), 6, drop_last=True, process_count=4)
    with pytest.raises(ValueError, match="requires drop_last"):
        Loader(_Indexed(8), 4, process_count=2)


@pytest.mark.parametrize("aug_type", ["CS-HF", "H-RP", "B-GS-R"])
def test_a_ranks_rows_take_the_global_batchs_draws(aug_type):
    """``prepare_batch(rows=(start, B))`` on a slice equals the slice of
    the one-process global batch, bit for bit, images and warped labels:
    N ranks see the batches of one process (JAX augments the global batch
    from one key, cli.py:404-430)."""
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (4, 16, 24, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 19, (4, 16, 24),
                                           dtype=np.uint8))
    cpu = torch.device("cpu")
    kw = dict(device=cpu, aug_type=aug_type, augment_labels=True)
    want = prepare_batch(images, labels,
                         generator=batch_generator(0, 1, 2, cpu), **kw)
    for start in (0, 2):
        got = prepare_batch(images[start:start + 2],
                            labels[start:start + 2],
                            generator=batch_generator(0, 1, 2, cpu),
                            rows=(start, 4), **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w[start:start + 2])


def test_num_devices_never_drops_ranks_or_the_card(monkeypatch):
    """``--num_devices N --cuda k`` takes cards k..k+N-1 or stops naming
    the count; it never runs fewer ranks or falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert cli.resolve_devices("1", 2) == [torch.device("cuda", 1),
                                           torch.device("cuda", 2)]
    with pytest.raises(SystemExit, match="needs 2 CUDA devices .* has 3"):
        cli.resolve_devices("2", 2)
    assert cli.resolve_devices("cpu", 4) == [torch.device("cpu")] * 4


def test_allreduce_counts_is_exact_above_int32(tmp_path):
    """Counts past 2^31 summed over two ranks as int64, exactly."""
    ranks = run_ranks(counts_above_int32, tmp_path)
    want = np.full((19, 19), 2 * (2**31 + 7), np.int64)
    want[0, 0] = 2**40 + 2**31 + 7
    want[1, 1] = 2**40 + 1 + 2**31 + 7
    for hist, correct, total in ranks:
        np.testing.assert_array_equal(hist, want)
        assert correct == 2 * 2**33 + 3
        assert total == 2 * 2**35 + 1


def test_sharded_eval_counts_equal_one_processs(tmp_path):
    """Five val images in strided shards over two ranks (3 and 2), rank 1
    with moved BN statistics evaluating under ``rank0_buffers``: the
    summed int64 confusion matrix, correct and pixel counts equal one
    process's over all five bit for bit, the (precision, mIoU) equal, and
    rank 1's own statistics come back; ``untile_state`` gives every rank
    rank 0's state."""
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (5, H, W, 3), dtype=np.uint8)
    labels = np.where(rng.uniform(size=(5, H, W)) < 0.1, 255,
                      rng.integers(0, 19, (5, H, W))).astype(np.uint8)
    pth = str(tmp_path / "init.pth")
    _seeded_pth(pth)
    state_path = str(tmp_path / "init.pt")
    torch.save(torch.load(pth, weights_only=True), state_path)
    ranks = run_ranks(sharded_eval, tmp_path, state_path=state_path,
                      images=images, labels=labels, perturb=True)

    model = BiSeNet(19)
    load_reference_state(model, torch.load(pth, weights_only=True),
                         strict=True)
    model.eval()
    cpu = torch.device("cpu")
    loader = [(torch.from_numpy(images[i:i + 1]),
               torch.from_numpy(labels[i:i + 1])) for i in range(5)]

    def prepare(batch):
        return prepare_batch(*batch, device=cpu)

    hist, correct, total = eval_counts(model, loader, 19, prepare=prepare,
                                       device=cpu)
    metrics = evaluate(model, loader, 19, prepare=prepare, device=cpu,
                       print_results=False)
    for r_hist, r_correct, r_total, r_metrics, untiled in ranks:
        np.testing.assert_array_equal(r_hist, hist.numpy())
        assert (r_correct, r_total) == (int(correct), total)
        assert r_metrics == metrics
        for key, value in model.state_dict().items():
            np.testing.assert_array_equal(untiled[key], value.numpy())


# ---------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    paths = {name: str(base / name) for name in ("cs", "gta")}
    _mk_cityscapes(paths["cs"], "train", n=4)
    _mk_cityscapes(paths["cs"], "val", n=2)
    _mk_gtav(paths["gta"], n=4)
    paths["g"] = str(base / "g.pth")
    _seeded_pth(paths["g"])
    paths["d"] = str(base / "d.pth")
    _seeded_d_pth(paths["d"], "fc")
    return paths


def _argv(trees, mode, save, log):
    argv = ["--root", trees["cs"], "--pretrain_path", trees["g"],
            "--crop_height", str(H), "--crop_width", str(W),
            "--faithful_resize", "False", "--eval_batch_size", "1",
            "--validation_step", "1", "--checkpoint_step", "1",
            "--max_steps_per_epoch", "1", "--num_workers", "1",
            "--dtype", "float32", "--tensorboard", "False",
            "--learning_rate", "1e-3", "--save_model_path", save,
            "--jsonl_log", log]
    if mode == "sync":
        return argv + ["--batch_size", "4", "--num_epochs", "3"]
    if mode == "replica":
        return argv + ["--batch_size", "4", "--num_epochs", "2",
                       "--sync_bn", "False"]
    return argv + ["--batch_size", "2", "--num_epochs", "2",
                   "--domain_adaptation", "True",
                   "--root_source", trees["gta"], "--root_target",
                   trees["cs"], "--d_pretrain_path", trees["d"]]


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _weights(save):
    return {name: torch.load(os.path.join(save, name), weights_only=True)
            for name in sorted(os.listdir(save)) if name.endswith(".pth")}


def _ranks_with_timeout(argv, timeout=RUN_TIMEOUT):
    """``cli.main(argv)``, which spawns its ranks, in a thread joined
    under ``timeout``: past it every rank process is killed (the CLI then
    stops with the rank's exit code) and the test fails, instead of a hung
    rank holding the run."""
    out = {}

    def run():
        try:
            out["result"] = cli.main(argv)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(timeout)
    if thread.is_alive():
        for child in multiprocessing.active_children():
            child.kill()
        thread.join(60)
        pytest.fail(f"the ranks ran past {timeout} s and were killed")
    if "error" in out:
        raise out["error"]
    return out["result"]


def _port_cli(trees, tmp_path, mode, name="port"):
    save, log = str(tmp_path / name), str(tmp_path / f"{name}.jsonl")
    res = _ranks_with_timeout(_argv(trees, mode, save, log)
                              + ["--num_devices", "2", "--cuda", "cpu"])
    return res, _log(log), save


@pytest.fixture(scope="module")
def sync_run(trees, tmp_path_factory):
    """The port's sync supervised run at --num_devices 2, kept for the
    runs held bit for bit against it."""
    monkey = pytest.MonkeyPatch()
    monkey.setenv("OMP_NUM_THREADS", "1")
    try:
        res, log, save = _port_cli(trees, tmp_path_factory.mktemp("sync"),
                                   "sync")
        weights = _weights(save)
    finally:
        monkey.undo()
    shutil.rmtree(save)
    return res, log, weights


def _jax_template():
    model = JaxBiSeNet(n_classes=19)
    return jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
            method=JaxBiSeNet.full_init)))


@pytest.mark.parametrize("mode", ["sync", "replica", "da"])
def test_cli_num_devices_2_matches_jax_cli(trees, sync_run, tmp_path, mode):
    """Per-epoch losses within rtol 1e-3 of the JAX CLI's (DA:
    ``loss_seg`` 1e-3, ``loss_D1`` 5e-3, each plus the miss of JAX by the
    port's one-process run of the same flags: at these seeds 9.4e-4 on
    epoch 1's ``loss_seg``, where the two ranks miss it by 9.9e-4), one
    log line an epoch (rank 0 alone logs); final and best mIoU within
    1e-3; the port's G ``.pth``
    (the ``module.``-prefixed ``GTA5_1.pth`` in DA) loads into the JAX
    package with all 216 tensors and the same values, and the JAX CLI's
    strictly into the port."""
    jax_save, jax_log = str(tmp_path / "jax"), str(tmp_path / "jax.jsonl")
    want = jax_cli.main(_argv(trees, mode, jax_save, jax_log)
                        + ["--num_devices", "2"])
    want_log = _log(jax_log)
    if mode == "sync":
        got, got_log, weights = sync_run
    else:
        got, got_log, save = _port_cli(trees, tmp_path, mode)
        weights = _weights(save)
    keys = ["loss_seg", "loss_adv"] if mode == "da" else ["loss"]
    rtols = [1e-3, 5e-3] if mode == "da" else [1e-3]
    assert len(got_log) == len(want_log) == (3 if mode == "sync" else 2)
    miss = {key: 0.0 for key in keys}
    if mode == "da":
        # D's sign-saturated first Adam step moves epoch 1 for the port in
        # one process too (ROADMAP.md Queue 3's gaps): its miss of JAX on
        # the same flags is allowed on top, as tests/test_torch_da.py does
        one_log = str(tmp_path / "one.jsonl")
        cli.main(_argv(trees, mode, str(tmp_path / "one"), one_log)
                 + ["--cuda", "cpu"])
        one = _log(one_log)
        shutil.rmtree(tmp_path / "one")
        miss = {key: np.abs(np.subtract([r[key] for r in one],
                                        [r[key] for r in want_log]))
                for key in keys}
    for key, rtol in zip(keys, rtols):
        g, w = [r[key] for r in got_log], [r[key] for r in want_log]
        print(f"{mode} {key}: port {g}, JAX {w}, one-process port's miss "
              f"{miss[key]}")
        assert np.all(np.abs(np.subtract(g, w))
                      <= rtol * np.abs(w) + miss[key]), (key, g, w)
    for key in ("miou", "max_miou"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got, want)
    name = "GTA5_1.pth" if mode == "da" else "best.pth"
    ours = weights[name]
    prefix = "module." if mode == "da" else ""
    assert all(k.startswith(prefix) for k in ours)
    path = str(tmp_path / "ours.pth")
    torch.save(ours, path)
    loaded, report = torch_io.load_pretrained(_jax_template(), path)
    assert len(report["loaded"]) == 216 and not report["shape_mismatch"]
    back = torch_io.variables_to_torch_state(loaded)
    for key, value in ours.items():
        np.testing.assert_array_equal(back[key[len(prefix):]], value.numpy())
    theirs = torch.load(os.path.join(jax_save, name), weights_only=True)
    assert len(load_reference_state(BiSeNet(19), theirs, strict=True)) \
        == 216
    shutil.rmtree(jax_save)
    if mode != "sync":
        shutil.rmtree(save)


def _process_ranks(argv, tmp_path, die_at=None):
    """The CLI as two OS processes, ranks of one group through a file
    store; returns (exit codes, stdouts)."""
    code = ["import sys", "from dasemanticsegmentationaml_tpu_torch import cli"]
    if die_at is not None:
        code += ["from dasemanticsegmentationaml_tpu_torch.data.pipeline "
                 "import Loader",
                 "set_epoch = Loader.set_epoch",
                 "def dying(self, epoch):",
                 f"    if epoch == {die_at}: raise SystemExit(3)",
                 "    set_epoch(self, epoch)",
                 "Loader.set_epoch = dying"]
    code.append("cli.main(sys.argv[1:])")
    store = f"file://{tmp_path}/store-{uuid.uuid4().hex[:8]}"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", "\n".join(code), *argv, "--cuda", "cpu",
         "--num_processes", "2", "--process_id", str(r),
         "--coordinator_address", store], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RUN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def test_cli_two_processes_equal_num_devices_bit_for_bit(trees, sync_run,
                                                         tmp_path):
    """``--num_processes 2`` ranks in two OS processes: per-epoch losses
    and every ``.pth`` bit-identical to the ``--num_devices 2`` run; only
    rank 0 prints the epoch lines."""
    _, want_log, want = sync_run
    save, log = str(tmp_path / "two"), str(tmp_path / "two.jsonl")
    codes, outs = _process_ranks(_argv(trees, "sync", save, log), tmp_path)
    assert codes == [0, 0], outs
    assert "loss for train" in outs[0] and "loss for train" not in outs[1]
    assert [r["loss"] for r in _log(log)] == [r["loss"] for r in want_log]
    got = _weights(save)
    assert sorted(got) == sorted(want) == ["best.pth", "latest.pth"]
    for name in want:
        for key, value in want[name].items():
            assert torch.equal(got[name][key], value), (name, key)
    shutil.rmtree(save)


def test_cli_resume_at_world_2_equals_the_straight_run(trees, sync_run,
                                                       tmp_path):
    """Two OS processes die as epoch 2 starts, after epoch 1's
    checkpoints; ``--resume <save>/state`` at world 2 restores every rank
    from rank 0's files and runs epoch 2: its loss and the final
    ``latest.pth`` equal the straight run's bit for bit."""
    _, want_log, want = sync_run
    save, log = str(tmp_path / "run"), str(tmp_path / "run.jsonl")
    argv = _argv(trees, "sync", save, log)
    codes, outs = _process_ranks(argv, tmp_path, die_at=2)
    assert codes == [3, 3], outs
    codes, outs = _process_ranks(
        argv + ["--resume", os.path.join(save, "state")], tmp_path)
    assert codes == [0, 0], outs
    assert "resumed from" in outs[0] and "at epoch 2" in outs[0]
    assert [r["loss"] for r in _log(log)] == [r["loss"] for r in want_log]
    latest = torch.load(os.path.join(save, "latest.pth"), weights_only=True)
    for key, value in want["latest.pth"].items():
        assert torch.equal(latest[key], value), key
    shutil.rmtree(save)
