"""The CLI on the height-sharded mesh against the JAX CLI, on the CPU.

``--num_devices 2 --spatial_devices 2 --cuda cpu`` (two spawned gloo
ranks, each a band of 64 of 128 image rows) against the JAX CLI at
``--num_devices 2 --spatial_devices 2`` (two of the virtual CPU devices
``tests/conftest.py`` makes, a 1 x 2 ('data', 'spatial') mesh), from one
``.pth`` of seeded weights on synthetic 128 x 64 trees, fp32, one step an
epoch at ``--learning_rate 1e-3``: supervised (batch 4) and DA (FC D,
batch 2), two epochs each. Bounds (PERF.md §2): per-epoch loss rtol 1e-3
(DA ``loss_D1`` 5e-3), mIoU |Δ| <= 1e-3; the port's ``.pth`` loads into
the JAX package and the JAX CLI's into the port. JAX's four refusals of
the mesh (cli.py:164-207) stop the port with JAX's words before any rank
starts. Each run's directory is deleted once read. About 100 s alone on
the CPU.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_da_cli import _seeded_d_pth
from test_torch_distributed import (_jax_template, _log,
                                    _ranks_with_timeout, _weights)
from test_torch_eval import _mk_cityscapes, _mk_gtav, _seeded_pth

from dasemanticsegmentationaml_tpu import cli as jax_cli
from dasemanticsegmentationaml_tpu.utils import torch_io
from dasemanticsegmentationaml_tpu_torch import cli
from dasemanticsegmentationaml_tpu_torch.models.bisenet import BiSeNet
from dasemanticsegmentationaml_tpu_torch.utils.weights import (
    load_reference_state)

H, W = 128, 64
MESH = ["--num_devices", "2", "--spatial_devices", "2"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    paths = {name: str(base / name) for name in ("cs", "gta")}
    _mk_cityscapes(paths["cs"], "train", n=4, size=(H, W))
    _mk_cityscapes(paths["cs"], "val", n=2, size=(H, W))
    _mk_gtav(paths["gta"], n=4, size=(H, W))
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
            "--jsonl_log", log, "--num_epochs", "2"]
    if mode == "supervised":
        return argv + ["--batch_size", "4"]
    return argv + ["--batch_size", "2", "--domain_adaptation", "True",
                   "--root_source", trees["gta"], "--root_target",
                   trees["cs"], "--d_pretrain_path", trees["d"]]


@pytest.mark.parametrize("mode", ["supervised", "da"])
def test_cli_spatial_devices_2_matches_jax_cli(trees, tmp_path, mode,
                                               monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    jax_save, jax_log = str(tmp_path / "jax"), str(tmp_path / "jax.jsonl")
    want = jax_cli.main(_argv(trees, mode, jax_save, jax_log) + MESH)
    want_log = _log(jax_log)
    save, log = str(tmp_path / "port"), str(tmp_path / "port.jsonl")
    got = _ranks_with_timeout(_argv(trees, mode, save, log) + MESH
                              + ["--cuda", "cpu"])
    got_log = _log(log)
    weights = _weights(save)
    keys = ["loss_seg", "loss_adv"] if mode == "da" else ["loss"]
    rtols = [1e-3, 5e-3] if mode == "da" else [1e-3]
    assert len(got_log) == len(want_log) == 2
    for key, rtol in zip(keys, rtols):
        g, w = [r[key] for r in got_log], [r[key] for r in want_log]
        print(f"{mode} {key}: port {g}, JAX {w}")
        np.testing.assert_allclose(g, w, rtol=rtol, err_msg=key)
    for key in ("miou", "max_miou"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got, want)
    name = "GTA5_1.pth" if mode == "da" else "best.pth"
    ours = weights[name]
    prefix = "module." if mode == "da" else ""
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
    shutil.rmtree(save)


@pytest.mark.parametrize("flags,match", [
    (["--num_processes", "2", "--process_id", "0", "--coordinator_address",
      "localhost:1234", "--spatial_devices", "2"],
     "--spatial_devices is single-process only"),
    (["--num_devices", "3", "--spatial_devices", "2"],
     "--spatial_devices 2 must divide the device count 3"),
    # under --faithful_resize (the default) the height is --crop_width:
    # 116 rows leave 29 at stride 4
    (MESH + ["--crop_width", "116"],
     "image height 116 is not spatially shardable over 2 devices: the "
     "stride-4 stage has 29 rows"),
    (MESH + ["--sync_bn", "False"],
     r"--sync_bn False \(per-replica BN\) is not supported with "
     "--spatial_devices"),
])
def test_cli_refuses_what_jax_refuses(flags, match):
    """JAX ``build_mesh``'s refusals, in its words, before any rank
    starts."""
    with pytest.raises(SystemExit, match=match):
        cli.main(["--domain_shift", "True", "--cuda", "cpu"] + flags)
