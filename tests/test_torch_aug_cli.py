"""The port's CLI with augmentation and ``--profile_dir``, on the CPU.

* ``--dataset GTAV --aug_type H-RP --host_augment True --augment_labels
  True`` on a 64 x 128 GTA5 tree against the JAX CLI, from one ``.pth`` of
  seeded weights, fp32, batch 4 (the whole 6-image train split's one
  batch), two epochs of one step: both augment on the host, bit for bit
  (tests/test_torch_host_augment.py), so their per-epoch losses agree
  within rtol 1e-3 (as tests/test_torch_train_cli.py holds the
  unaugmented CLIs), and closer than augmenting or not moves the port's
  epoch-1 loss. The learning rate is 1e-3: at the default 0.01 the first
  fp32 step from these random weights already parts the two CLIs by
  2.6e-3 at epoch 1 on this tree without augmentation (2e-5 at 1e-3),
  the gap ROADMAP.md Queue 3 records for fp32 steps. This is the one JAX
  CLI compile of the augmentation tests.
* ``resolve_host_augment`` equals the JAX function on every row.
* The DA CLI with ``--aug_type CS-HF`` on the device trains and gives the
  same losses twice; ``--fast_device_geometry`` changes nothing.
* ``--profile_dir`` writes a trace.
"""

import glob
import itertools
import json
import os

import numpy as np
import pytest

from test_torch_eval import H, W, _mk_cityscapes, _mk_gtav, _seeded_pth

from dasemanticsegmentationaml_tpu import cli as jax_cli
from dasemanticsegmentationaml_tpu_torch import cli


def _losses(path, key):
    with open(path) as f:
        return [json.loads(line)[key] for line in f]


def _common(tmp_path, name):
    return ["--crop_height", str(H), "--crop_width", str(W),
            "--faithful_resize", "False", "--batch_size", "2",
            "--eval_batch_size", "2", "--num_epochs", "2",
            "--validation_step", "1", "--checkpoint_step", "1",
            "--max_steps_per_epoch", "1", "--num_workers", "1",
            "--dtype", "float32", "--tensorboard", "False",
            "--save_model_path", str(tmp_path / name),
            "--jsonl_log", str(tmp_path / f"{name}.jsonl")]


def test_host_augment_cli_matches_jax(tmp_path, monkeypatch):
    from dasemanticsegmentationaml_tpu.data import native as jax_native

    # the JAX package loads its built library or runs numpy (the same
    # bits); it is not rebuilt in place
    monkeypatch.setattr(jax_native, "_build", lambda: False)
    root = str(tmp_path / "gta")
    _mk_gtav(root, n=8)
    pth = str(tmp_path / "init.pth")
    _seeded_pth(pth)
    base = ["--dataset", "GTAV", "--root", root, "--pretrain_path", pth,
            "--learning_rate", "1e-3"]
    aug = ["--aug_type", "H-RP", "--host_augment", "True",
           "--augment_labels", "True"]

    def run(main, name, flags):
        argv = base + flags + _common(tmp_path, name)
        argv[argv.index("--batch_size") + 1] = "4"
        result = main(argv)
        return result, np.array(_losses(tmp_path / f"{name}.jsonl", "loss"))

    _, want = run(jax_cli.main, "jax", aug + ["--num_devices", "1"])
    got_result, got = run(cli.main, "port", aug + ["--cuda", "cpu"])
    _, plain = run(cli.main, "plain", ["--cuda", "cpu"])
    assert len(got) == len(want) == 2 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert abs(got[1] - want[1]) < abs(got[1] - plain[1])
    assert 0.0 <= got_result["miou"] <= 1.0


def test_resolve_host_augment_matches_jax():
    rows = itertools.product((None, "CS-HF", "H-RP", "B-GS-R"),
                             (None, True, False),
                             ("cpu", "cuda", "gpu", "tpu"), (False, True),
                             (None, 1, 8))
    for aug_type, host, backend, fast, cores in rows:
        got = cli.resolve_host_augment(aug_type, host, backend,
                                       fast_geometry=fast, host_cores=cores)
        want = jax_cli.resolve_host_augment(aug_type, host, backend,
                                            fast_geometry=fast,
                                            host_cores=cores)
        assert got == want
    # off the TPU "auto" stays on the device
    assert cli.resolve_host_augment("H-RP", None, "cuda") == (False, None)


@pytest.fixture(scope="module")
def da_trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("da_aug")
    paths = {name: str(base / name) for name in ("cs", "tgt", "gta")}
    _mk_cityscapes(paths["cs"], "val", n=2)
    _mk_cityscapes(paths["tgt"], "train", n=4)
    _mk_gtav(paths["gta"], n=4)
    return paths


def test_da_cli_augments_on_the_device_reproducibly(da_trees, tmp_path,
                                                    capsys):
    argv = ["--domain_adaptation", "True", "--root", da_trees["cs"],
            "--root_source", da_trees["gta"], "--root_target",
            da_trees["tgt"], "--cuda", "cpu"]
    aug = ["--aug_type", "CS-HF"]
    runs = []
    for name, extra in (("a", aug),
                        ("b", aug + ["--fast_device_geometry", "True"]),
                        ("plain", [])):
        cli.main(argv + extra + _common(tmp_path, name))
        runs.append(_losses(tmp_path / f"{name}.jsonl", "loss_seg")
                    + _losses(tmp_path / f"{name}.jsonl", "loss_adv"))
    assert cli.FAST_GEOMETRY_NOTE in capsys.readouterr().out
    assert np.isfinite(runs[0]).all() and len(runs[0]) == 4
    assert runs[0] == runs[1]  # reproducible; the flag is inert
    assert runs[0] != runs[2]  # and the augmentation took part


def test_profile_dir_writes_a_trace(tmp_path):
    root = str(tmp_path / "cs")
    _mk_cityscapes(root, "train", n=2)
    _mk_cityscapes(root, "val", n=2)
    trace_dir = tmp_path / "trace"
    cli.main(["--root", root, "--cuda", "cpu", "--profile_dir",
              str(trace_dir)] + _common(tmp_path, "run"))
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
