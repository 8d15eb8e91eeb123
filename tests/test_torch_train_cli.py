"""The port's supervised CLI against the JAX CLI, on the CPU.

Both train BiSeNet-STDC813 from one ``.pth`` of seeded weights on one
synthetic 4-image Cityscapes tree at 64 x 128, fp32, batch 2, for two
epochs of one step each (``--max_steps_per_epoch 1``), validating and
checkpointing every epoch. Their per-epoch losses (read from
``--jsonl_log``) must agree within rtol 1e-3, and their final weights
within test_train_equivalence.py's step-2 bounds (update-relative, :256-
260), which also sees the epoch-1 learning rate. One step per epoch,
because fp32 rounding compounds fast from these weights: over four steps
the port's own fp32 losses drift 1e-3 from its fp64 ones, and XLA's 4e-3.
Each side's ``best.pth`` must load into the other: the port's into the
JAX package through ``torch_io.load_pretrained`` (all 216 tensors), the
JAX CLI's strictly into the port.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_eval import H, W, _mk_cityscapes, _seeded_pth
from test_train_equivalence import _assert_state_close

from dasemanticsegmentationaml_tpu import cli as jax_cli
from dasemanticsegmentationaml_tpu.models.bisenet import BiSeNet as JaxBiSeNet
from dasemanticsegmentationaml_tpu.utils import torch_io
from dasemanticsegmentationaml_tpu_torch import cli
from dasemanticsegmentationaml_tpu_torch.models.bisenet import BiSeNet
from dasemanticsegmentationaml_tpu_torch.utils.weights import (
    load_reference_state)


def _epoch_losses(path):
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


def test_supervised_cli_matches_jax(tmp_path):
    root = str(tmp_path / "data")
    _mk_cityscapes(root, "train", n=4)
    _mk_cityscapes(root, "val", n=2)
    pth = str(tmp_path / "init.pth")
    _seeded_pth(pth)
    argv = ["--root", root, "--pretrain_path", pth,
            "--crop_height", str(H), "--crop_width", str(W),
            "--faithful_resize", "False", "--batch_size", "2",
            "--eval_batch_size", "2", "--num_epochs", "2",
            "--validation_step", "1", "--checkpoint_step", "1",
            "--max_steps_per_epoch", "1", "--num_workers", "1",
            "--dtype", "float32", "--tensorboard", "False"]
    runs = {}
    for name, main, extra in (("jax", jax_cli.main, ["--num_devices", "1"]),
                              ("port", cli.main, ["--cuda", "cpu"])):
        save = str(tmp_path / name)
        log = str(tmp_path / f"{name}.jsonl")
        res = main(argv + extra + ["--save_model_path", save,
                                   "--jsonl_log", log])
        runs[name] = (res, _epoch_losses(log), save)
    (want, want_losses, jax_dir), (got, got_losses, port_dir) = (
        runs["jax"], runs["port"])
    assert len(got_losses) == len(want_losses) == 2
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-3)
    assert np.isfinite(got_losses).all()
    assert 0.0 <= got["miou"] <= 1.0 and 0.0 <= got["max_miou"] <= 1.0
    for d in (jax_dir, port_dir):
        assert {"latest.pth", "best.pth"} <= set(os.listdir(d))

    # the port's best.pth into the JAX package: every tensor, same values
    model = JaxBiSeNet(n_classes=19)
    template = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
            method=JaxBiSeNet.full_init)))
    port_best = os.path.join(port_dir, "best.pth")
    loaded, report = torch_io.load_pretrained(template, port_best)
    assert len(report["loaded"]) == 216
    assert not report["shape_mismatch"]
    saved = torch.load(port_best, weights_only=True)
    back = torch_io.variables_to_torch_state(loaded)
    assert sorted(back) == sorted(saved)
    for key, value in saved.items():
        np.testing.assert_array_equal(back[key], value.numpy())

    # the JAX CLI's best.pth strictly into the port
    fresh = BiSeNet(19)
    jax_best = torch.load(os.path.join(jax_dir, "best.pth"),
                          weights_only=True)
    assert len(load_reference_state(fresh, jax_best, strict=True)) == 216

    # the final weights (latest.pth, after both steps) against each other
    init_state = {k: np.array(v) for k, v in
                  torch_io.read_torch_checkpoint(pth).items()}
    jax_final, _ = torch_io.load_pretrained(
        template, os.path.join(jax_dir, "latest.pth"))
    port_final = BiSeNet(19)
    load_reference_state(port_final, torch.load(
        os.path.join(port_dir, "latest.pth"), weights_only=True))
    _assert_state_close(jax_final, port_final, init_state,
                        what="CLI final state", g_tol=0.40, rs_tol=0.35,
                        leaf_tol=1.2)


def test_supervised_cli_cuda_flag_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(["--cuda", "0", "--root", str(tmp_path)])
