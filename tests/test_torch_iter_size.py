"""``--iter_size``: the port's ``GradientAccumulator`` against
``optax.MultiSteps``, on the CPU.

One pair of mini-steps of the port's ``make_train_step`` with a
``GradientAccumulator(k=2)`` against the JAX step over
``optax.MultiSteps(sgd, every_k_schedule=2)`` (JAX cli.py:719-722), on the
same seeded weights (tests/test_torch_train.py's ``seeded_pair``) and
batches: mini-step 1 leaves every parameter bit-identical and moves the
BN statistics (as JAX's does); mini-step 2 is held to
test_train_equivalence.py's step-1 bounds (losses rtol 1e-3;
update-relative global l2 < 0.02, running stats < 0.02; each leaf within
0.1 of its update of an fp64 run of the port). The accumulator's own
arithmetic is held to optax's running mean on explicit gradients. Then
the port's ``--iter_size 2`` CLI against the JAX CLI, 2 epochs of 3
mini-steps: per-epoch losses rtol 1e-3, at ``--learning_rate 1e-3`` as
tests/test_torch_aug_cli.py runs (at 0.01 the two differ by 9.8e-4 at
epoch 1, the fp32 drift of ROADMAP.md Queue 3's gaps).

Adds about 70 s alone on the CPU (a JAX step and the JAX CLI).
"""

import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from test_torch_eval import H, W, _mk_cityscapes, _seeded_pth
from test_torch_train import LR, WD, _ce_float64, _port_model, seeded_pair  # noqa: F401
from test_train_equivalence import _assert_state_close, _batches

from dasemanticsegmentationaml_tpu import cli as jax_cli
from dasemanticsegmentationaml_tpu.models.bisenet import unused_param_mask
from dasemanticsegmentationaml_tpu.train import (create_train_state,
                                                 make_train_step as
                                                 jax_make_train_step)
from dasemanticsegmentationaml_tpu.train import optim as jax_optim
from dasemanticsegmentationaml_tpu_torch import cli
from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
    trainable_parameters)
from dasemanticsegmentationaml_tpu_torch.train.optim import (
    GradientAccumulator, make_optimizer)
from dasemanticsegmentationaml_tpu_torch.train.supervised import (
    make_train_step)


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


def test_running_mean_is_optax_multisteps():
    """Three emits of k=3 over explicit gradients (a parameter without a
    gradient included): the parameters after every mini-step equal
    MultiSteps' within 1e-6, and between emits they do not move."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(5).astype(np.float32)
    q0 = rng.standard_normal(3).astype(np.float32)
    grads = [rng.standard_normal(5).astype(np.float32) for _ in range(9)]

    tp = torch.nn.Parameter(torch.tensor(p0.copy()))
    tq = torch.nn.Parameter(torch.tensor(q0.copy()))
    opt = make_optimizer("sgd", [tp, tq], 0.01, momentum=0.9,
                         weight_decay=1e-4)
    acc = GradientAccumulator(opt, 3)
    jopt = optax.MultiSteps(jax_optim.make_optimizer(
        "sgd", 0.01, momentum=0.9, weight_decay=1e-4), every_k_schedule=3)
    params = {"p": jnp.asarray(p0), "q": jnp.asarray(q0)}
    st = jopt.init(params)
    for i, g in enumerate(grads):
        before = tp.detach().clone()
        opt.zero_grad(set_to_none=True)
        tp.grad = torch.tensor(g.copy())  # tq gets none: zeros in optax
        stepped = acc.step()
        assert stepped == (i % 3 == 2)
        if not stepped:
            assert torch.equal(tp.detach(), before)
        u, st = jopt.update({"p": jnp.asarray(g), "q": jnp.zeros(3)}, st,
                            params)
        params = jax.tree.map(lambda a, b: a + b, params, u)
        np.testing.assert_allclose(tp.detach().numpy(),
                                   np.asarray(params["p"]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(tq.detach().numpy(),
                                   np.asarray(params["q"]), rtol=0,
                                   atol=1e-6)
        assert acc.mini_step == int(st.mini_step)


def _port_pair(state, batches, dtype, **kw):
    """Two mini-steps of k=2 in ``dtype``: losses and a state snapshot
    after each."""
    model = _port_model(state).to(dtype)
    opt = make_optimizer("sgd", trainable_parameters(model), LR,
                         momentum=0.9, weight_decay=WD)
    step = make_train_step(model, opt,
                           accumulator=GradientAccumulator(opt, 2), **kw)
    losses, snaps = [], []
    for x, y in batches:
        losses.append(step(torch.from_numpy(x).to(dtype),
                           torch.from_numpy(y.astype(np.int32))).item())
        snaps.append({k: v.to(torch.float64, copy=True).numpy()
                      for k, v in model.state_dict().items()})
    return model, losses, snaps


def test_multisteps_pair_matches_jax(seeded_pair):
    jax_model, variables, state = seeded_pair
    batches = _batches(2, seed=0)
    model, losses, snaps = _port_pair(state, batches, torch.float32)
    _, losses64, snaps64 = _port_pair(state, batches, torch.float64,
                                      ce=_ce_float64)
    init_state = {k: v.double().numpy()
                  for k, v in _port_model(state).state_dict().items()}

    jopt = optax.MultiSteps(jax_optim.make_optimizer(
        "sgd", LR, momentum=0.9, weight_decay=WD,
        mask=unused_param_mask(variables["params"])), every_k_schedule=2)
    jstate = create_train_state(variables, jopt)
    jstep = jax_make_train_step(jax_model, jopt, donate=False)
    jlosses, jvars = [], []
    for x, y in batches:
        jstate, loss = jstep(jstate, jnp.asarray(x.transpose(0, 2, 3, 1)),
                             jnp.asarray(y.astype(np.int32)), LR)
        jlosses.append(float(loss))
        jvars.append({"params": jax.device_get(jstate.params),
                      "batch_stats": jax.device_get(jstate.batch_stats)})
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    np.testing.assert_allclose(losses, losses64, rtol=1e-5)

    # mini-step 1: no parameter moves (here or in JAX); BN statistics do
    params = {n for n, _ in model.named_parameters()}
    moved, still = set(), set()
    for key, v in snaps[0].items():
        if key in params:
            np.testing.assert_array_equal(v, init_state[key], err_msg=key)
        elif key.endswith("running_mean"):
            (still if np.array_equal(v, init_state[key]) else moved).add(key)
    # every BN that ran; the ImageNet head's two did not run
    assert still == {"cp.backbone.bn.running_mean",
                     "cp.backbone.conv_last.bn.running_mean"}
    assert len(moved) == 40
    jax.tree.map(np.testing.assert_array_equal, jvars[0]["params"],
                 variables["params"])

    # mini-step 2: the step-1 bounds, against JAX and per leaf against fp64
    model.load_state_dict({k: torch.from_numpy(v).float()
                           for k, v in snaps[1].items()})
    _assert_state_close(jvars[1], model, init_state, what="mini-step 2",
                        leaf_tol=None)
    n = 0
    for key, exact in snaps64[1].items():
        upd = np.abs(exact - init_state[key]).max()
        if upd < 1e-12 or key.endswith(("running_mean", "running_var",
                                        "num_batches_tracked")):
            continue
        assert np.abs(snaps[1][key] - exact).max() / upd < 0.1, key
        n += 1
    assert n == len(list(trainable_parameters(model)))  # every one moved


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("iter_size")
    root = str(base / "cs")
    _mk_cityscapes(root, "train", n=6)
    _mk_cityscapes(root, "val", n=2)
    pth = str(base / "g.pth")
    _seeded_pth(pth)
    argv = ["--root", root, "--pretrain_path", pth,
            "--crop_height", str(H), "--crop_width", str(W),
            "--faithful_resize", "False", "--batch_size", "2",
            "--eval_batch_size", "2", "--num_epochs", "2",
            "--validation_step", "1", "--checkpoint_step", "1",
            "--max_steps_per_epoch", "3", "--iter_size", "2",
            "--learning_rate", "1e-3", "--num_workers", "1",
            "--dtype", "float32", "--tensorboard", "False"]
    out = {}
    for name, main, extra in (("jax", jax_cli.main, ["--num_devices", "1"]),
                              ("port", cli.main, ["--cuda", "cpu"])):
        log = str(base / f"{name}.jsonl")
        save = str(base / name)
        res = main(argv + extra + ["--save_model_path", save,
                                   "--jsonl_log", log])
        state = (torch.load(os.path.join(save, "state", "latest.pt"),
                            weights_only=True) if name == "port" else None)
        with open(log) as f:
            out[name] = (res, [json.loads(line)["loss"] for line in f],
                         state)
        shutil.rmtree(save)  # weights and states, 0.2-0.3 GB a side
    return out


def test_iter_size_cli_matches_jax(cli_runs):
    (want, want_losses, _), (got, got_losses, state) = (cli_runs["jax"],
                                                        cli_runs["port"])
    assert len(got_losses) == len(want_losses) == 2
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-3)
    assert 0.0 <= got["miou"] <= 1.0
    # 6 mini-steps: three optimizer steps, nothing left accumulating
    assert state["accumulator"]["mini_step"] == 0
