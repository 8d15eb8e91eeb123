"""The port's domain-adaptation CLI against the JAX DA CLI, on the CPU.

Both adapt BiSeNet-STDC813 from one ``.pth`` of seeded weights, with a
discriminator from one seeded ``--d_pretrain_path`` file, from a synthetic
GTA5 tree to a synthetic Cityscapes train split at 64 x 128, fp32, batch
2, for two epochs of one step each, checkpointing and validating every
epoch. One step per epoch, because fp32 rounding compounds over more
(ROADMAP.md Queue 3). Their per-epoch ``loss_seg`` and ``loss_D1`` (read
from ``--jsonl_log``, where they are ``loss_seg`` and ``loss_adv``) must
agree within rtol 1e-3 and 5e-3: ``loss_D1`` is the sum of D's two BCEs,
held to tests/test_torch_da.py's step bound on it. Its target half comes
after D's first Adam step, which is sign-saturated, so near-zero gradient
elements that rounding flips move it: at these seeds port and JAX differ
by 8e-4 in epoch 0 and 2.8e-3 in epoch 1, and on ``loss_seg`` by 3e-7
and 3.6e-4. ``GTA5_1.pth`` and ``GTA5_1_D1.pth`` must carry
the same ``module.``-prefixed keys on both sides, and each side's files
must load into the other. The port's own runs cover the other options:
the depthwise discriminators' counts, ``--d_pretrain_path`` round trips
and kind checks, ``--da_step_mode combined`` and ``--nni_faithful_lr``.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_eval import H, W, _mk_cityscapes, _mk_gtav, _seeded_pth
from test_torch_models import seeded_variables

from dasemanticsegmentationaml_tpu import cli as jax_cli
from dasemanticsegmentationaml_tpu.models.bisenet import BiSeNet as JaxBiSeNet
from dasemanticsegmentationaml_tpu.models.discriminator import (
    build_discriminator as jax_build_discriminator)
from dasemanticsegmentationaml_tpu.utils import torch_io
from dasemanticsegmentationaml_tpu_torch import cli
from dasemanticsegmentationaml_tpu_torch.models.bisenet import BiSeNet
from dasemanticsegmentationaml_tpu_torch.models.discriminator import (
    build_discriminator)
from dasemanticsegmentationaml_tpu_torch.utils.weights import (
    load_pretrain_discriminator, load_reference_state)

#: --depthwise, --batch_norm -> the count the trainer prints (train.py:295)
D_FLAGS = {"fc": (["--depthwise", "False"], 2_781_121),
           "dw": (["--depthwise", "True", "--batch_norm", "False"], 190_340),
           "dwbn": (["--depthwise", "True", "--batch_norm", "True"], 193_194)}


def _seeded_d_pth(path, kind):
    """A .pth of seeded discriminator weights, written by the JAX package."""
    depthwise, batch_norm = {"fc": (False, False), "dw": (True, False),
                             "dwbn": (True, True)}[kind]
    jax_d = jax_build_discriminator(19, depthwise, batch_norm)
    variables = seeded_variables(
        lambda: jax_d.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 19))),
        seed=7)
    torch_io.write_torch_checkpoint(
        path, torch_io.variables_to_torch_state(variables))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The three synthetic trees (val-only --root, as tests/test_cli.py
    ::test_cli_domain_adaptation) and the seeded G and D files."""
    base = tmp_path_factory.mktemp("da")
    paths = {name: str(base / name) for name in ("cs", "tgt", "gta")}
    _mk_cityscapes(paths["cs"], "val", n=2)
    _mk_cityscapes(paths["tgt"], "train", n=4)
    _mk_gtav(paths["gta"], n=4)
    paths["g"] = str(base / "g.pth")
    _seeded_pth(paths["g"])
    for kind in D_FLAGS:
        paths[kind] = str(base / f"d_{kind}.pth")
        _seeded_d_pth(paths[kind], kind)
    return paths


def _argv(trees, kind, save, log):
    return ["--root", trees["cs"], "--root_source", trees["gta"],
            "--root_target", trees["tgt"], "--domain_adaptation", "True",
            "--pretrain_path", trees["g"], "--d_pretrain_path", trees[kind],
            "--crop_height", str(H), "--crop_width", str(W),
            "--faithful_resize", "False", "--batch_size", "2",
            "--eval_batch_size", "2", "--num_epochs", "2",
            "--validation_step", "1", "--checkpoint_step", "1",
            "--max_steps_per_epoch", "1", "--num_workers", "1",
            "--dtype", "float32", "--tensorboard", "False",
            "--save_model_path", save, "--jsonl_log", log] + D_FLAGS[kind][0]


def _epoch_losses(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r["loss_seg"] for r in rows], [r["loss_adv"] for r in rows]


def _port_run(trees, tmp_path, kind, *extra):
    save, log = str(tmp_path / "port"), str(tmp_path / "port.jsonl")
    res = cli.main(_argv(trees, kind, save, log) + ["--cuda", "cpu", *extra])
    return res, _epoch_losses(log), save


def test_da_cli_matches_jax(trees, tmp_path):
    """FC discriminator, the reference's 4-phase step."""
    jax_save, jax_log = str(tmp_path / "jax"), str(tmp_path / "jax.jsonl")
    want = jax_cli.main(_argv(trees, "fc", jax_save, jax_log)
                        + ["--num_devices", "1"])
    want_seg, want_adv = _epoch_losses(jax_log)
    got, (got_seg, got_adv), port_save = _port_run(trees, tmp_path, "fc")
    print(f"loss_seg port {got_seg} JAX {want_seg}; loss_D1 port {got_adv} "
          f"JAX {want_adv}")
    assert len(got_seg) == len(want_seg) == 2
    assert np.isfinite(got_seg + got_adv).all()
    np.testing.assert_allclose(got_seg, want_seg, rtol=1e-3)
    np.testing.assert_allclose(got_adv, want_adv, rtol=5e-3)
    for res in (got, want):
        assert 0.0 <= res["miou"] <= 1.0 and 0.0 <= res["max_miou"] <= 1.0

    names = ("GTA5_1.pth", "GTA5_1_D1.pth")
    for name in names:
        ours = torch.load(os.path.join(port_save, name), weights_only=True)
        theirs = torch_io.read_torch_checkpoint(os.path.join(jax_save, name))
        assert set(ours) == set(theirs), name
        assert all(k.startswith("module.") for k in ours), name
    if os.path.exists(os.path.join(port_save, "best.pth")):
        assert os.path.exists(os.path.join(port_save, "best_D1.pth"))

    # the port's files into the JAX package: every tensor, same values
    g_template = JaxBiSeNet(n_classes=19).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        method=JaxBiSeNet.full_init)
    d_template = jax_build_discriminator(19, False, False).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 19)))
    for name, template, n in ((names[0], g_template, 216),
                              (names[1], d_template, 10)):
        path = os.path.join(port_save, name)
        loaded, report = torch_io.load_pretrained(template, path)
        assert len(report["loaded"]) == n, name
        assert not report["not_in_model"] and not report["shape_mismatch"]
        back = torch_io.variables_to_torch_state(loaded)
        for key, value in torch.load(path, weights_only=True).items():
            np.testing.assert_array_equal(back[key[len("module."):]],
                                          value.numpy())
    # the JAX CLI's files strictly into the port
    assert len(load_reference_state(BiSeNet(19), torch.load(
        os.path.join(jax_save, names[0]), weights_only=True))) == 216
    assert len(load_reference_state(build_discriminator(19), torch.load(
        os.path.join(jax_save, names[1]), weights_only=True))) == 10


@pytest.mark.parametrize("kind,extra", [
    ("dwbn", ["--da_step_mode", "combined"]),
    ("dw", ["--nni_faithful_lr", "True", "--d_head", "2"]),
])
def test_da_cli_options_run(trees, tmp_path, capsys, kind, extra):
    """The depthwise discriminators print the reference's counts; the
    combined step, the NNI LR dataflow and the out32 head run to finite
    losses and write the reference's four files."""
    res, (seg, adv), save = _port_run(trees, tmp_path, kind, *extra)
    out = capsys.readouterr().out
    assert f"The discriminator has:  {D_FLAGS[kind][1]}" in out
    assert "You are using depthwise separable convolution" in out
    assert len(seg) == 2 and np.isfinite(seg + adv).all()
    assert np.isfinite(res["miou"])
    assert {"GTA5_1.pth", "GTA5_1_D1.pth"} <= set(os.listdir(save))


def test_d_pretrain_path_round_trips_and_checks_the_kind(trees, tmp_path):
    """A GTA5_<n>_D1.pth written by the port loads back through
    --d_pretrain_path with every tensor; a discriminator of another kind
    stops the run with the JAX CLI's message."""
    _, _, save = _port_run(trees, tmp_path / "a", "dwbn")
    written = os.path.join(save, "GTA5_1_D1.pth")
    d = build_discriminator(19, True, True)
    load_pretrain_discriminator(d, written)
    saved = torch.load(written, weights_only=True)
    state = d.state_dict()
    assert len(saved) == 50
    for key, value in saved.items():
        assert torch.equal(state[key[len("module."):]], value)
    argv = _argv(trees, "dwbn", str(tmp_path / "b"),
                 str(tmp_path / "b.jsonl"))
    argv[argv.index("--d_pretrain_path") + 1] = trees["fc"]
    with pytest.raises(SystemExit, match="check --depthwise/--batch_norm"):
        cli.main(argv + ["--cuda", "cpu"])
