"""The port's supervised training pieces against the JAX package, on the CPU.

Optimizer update rules, the LR schedule, the frozen ImageNet head, BN in
train mode, whole fp32 train steps and the shuffled loader order are each
held against their JAX counterparts. Weights cross over as in
tests/test_torch_models.py: seeded numpy values in the JAX variables,
``variables_to_torch_state`` to the port; the port's state comes back
through ``torch_io.load_into_variables`` (test_train_equivalence.py:63-71)
and is compared with that file's update-relative bounds, which it
calibrated for two fp32 implementations of the same step.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from flax import traverse_util

from test_torch_models import seeded_variables
from test_train_equivalence import (_assert_state_close, _batches,
                                    _load_torch_state_into)

from dasemanticsegmentationaml_tpu.data.pipeline import Loader as JaxLoader
from dasemanticsegmentationaml_tpu.models.bisenet import BiSeNet as JaxBiSeNet
from dasemanticsegmentationaml_tpu.models.bisenet import unused_param_mask
from dasemanticsegmentationaml_tpu.ops import schedules as jax_schedules
from dasemanticsegmentationaml_tpu.train import (create_train_state,
                                                 make_train_step as
                                                 jax_make_train_step)
from dasemanticsegmentationaml_tpu.train import optim as jax_optim
from dasemanticsegmentationaml_tpu.utils import torch_io
from dasemanticsegmentationaml_tpu_torch.data.pipeline import Loader
from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
    BiSeNet, trainable_parameters)
from dasemanticsegmentationaml_tpu_torch.ops import schedules
from dasemanticsegmentationaml_tpu_torch.train.optim import (
    make_optimizer, set_learning_rate)
from dasemanticsegmentationaml_tpu_torch.train.supervised import (
    make_train_step)
from dasemanticsegmentationaml_tpu_torch.utils.weights import (
    load_reference_state)

H, W = 64, 128
LR, WD = 0.01, 1e-4


@pytest.fixture(scope="module")
def seeded_pair():
    """A full-width JAX BiSeNet's seeded variables and the reference-named
    state dict that carries them to the port."""
    jax_model = JaxBiSeNet(n_classes=19, dtype=jnp.float32)
    variables = seeded_variables(
        lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
                               method=JaxBiSeNet.full_init), seed=0)
    return jax_model, variables, torch_io.variables_to_torch_state(variables)


def _port_model(state):
    model = BiSeNet(19)
    load_reference_state(model, state, strict=True)
    return model.train()


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", dict(momentum=0.9, weight_decay=1e-4)),
    ("sgd", dict(momentum=0.9, weight_decay=5e-4)),
    ("adam", dict(betas=(0.9, 0.99))),
    ("rmsprop", dict()),
])
def test_optimizer_update_rules_match_jax(name, kwargs):
    """Six controlled gradient steps (test_train_equivalence.py:162):
    the port's torch.optim update equals the JAX optax chain within 1e-6."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(7).astype(np.float32)
    grads = [rng.standard_normal(7).astype(np.float32) for _ in range(6)]

    tp = torch.nn.Parameter(torch.tensor(p0.copy()))
    opt = make_optimizer(name, [tp], 0.01, **kwargs)
    for g in grads:
        opt.zero_grad()
        set_learning_rate(opt, 0.01)
        tp.grad = torch.tensor(g.copy())
        opt.step()

    jopt = jax_optim.make_optimizer(name, 0.01, **kwargs)
    params = {"w": jnp.asarray(p0.copy())}
    st = jopt.init(params)
    for g in grads:
        st = jax_optim.set_learning_rate(st, 0.01)
        u, st = jopt.update({"w": jnp.asarray(g)}, st, params)
        params = {"w": params["w"] + u["w"]}
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(params["w"]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["standard", "compounding"])
def test_poly_lr_matches_jax(mode):
    ours = schedules.PolyLR(0.01, 50, mode=mode)
    theirs = jax_schedules.PolyLR(0.01, 50, mode=mode)
    assert [ours(e) for e in range(50)] == [theirs(e) for e in range(50)]


@pytest.mark.parametrize("use_conv_last", [False, True])
def test_trainable_parameters_match_jax_mask(seeded_pair, use_conv_last):
    """The parameters given to the optimizer are exactly the leaves the
    JAX mask leaves trainable."""
    _, variables, state = seeded_pair
    mask = traverse_util.flatten_dict(
        unused_param_mask(variables["params"], use_conv_last))
    params = traverse_util.flatten_dict(variables["params"])
    trainable = [torch_io.flax_path_to_torch("params", path,
                                             params[path].ndim)[0]
                 for path, keep in mask.items() if keep]
    model = BiSeNet(19)
    names = {id(p): n for n, p in model.named_parameters()}
    got = sorted(names[id(p)] for p in trainable_parameters(model,
                                                            use_conv_last))
    assert got == sorted(trainable)
    frozen = set(names.values()) - set(got)
    assert frozen == ({"cp.backbone.fc.weight", "cp.backbone.bn.weight",
                       "cp.backbone.bn.bias", "cp.backbone.linear.weight"}
                      | (set() if use_conv_last else
                         {"cp.backbone.conv_last.conv.weight",
                          "cp.backbone.conv_last.bn.weight",
                          "cp.backbone.conv_last.bn.bias"}))


def test_train_mode_features_and_running_stats_match_jax(seeded_pair):
    """Train-mode BN at full width, 2x3x64x128, fp32: the heads within
    1e-4 of their max, the updated running statistics within 1e-4 of
    each leaf's max (batch statistics of a 2x4x8 map at stride 32 make
    the heads sensitive to the summation order)."""
    jax_model, variables, state = seeded_pair
    x = np.random.default_rng(5).standard_normal((2, H, W, 3)).astype(
        np.float32)
    want, mutated = jax_model.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"],
                                    method=JaxBiSeNet.features)
    model = _port_model(state)
    with torch.no_grad():
        got = model.features(torch.from_numpy(
            np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    new_stats = torch_io.variables_to_torch_state(
        {"batch_stats": mutated["batch_stats"]})
    ours = model.state_dict()
    moved = 0
    for key, w in new_stats.items():
        g = ours[key].numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)
        moved += not np.array_equal(w, state[key])
    # every BN that ran moved its statistics; the ImageNet head's did not
    assert moved == len(new_stats) - 4
    assert int(ours["cp.conv_avg.bn.num_batches_tracked"]) == 1


def _ce_float64(logits, labels, out_hw, ignore_index):
    """fp64 CE(ignore) of the align_corners upsample, for the fp64 run."""
    up = F.interpolate(logits, out_hw, mode="bilinear", align_corners=True)
    valid = (labels != ignore_index) & (labels >= 0) & (labels < up.shape[1])
    loss = F.cross_entropy(up, torch.where(valid, labels, 0).long(),
                           reduction="none")
    return torch.where(valid, loss, 0.0).sum() / valid.sum().clamp_min(1)


def _port_steps(state, batches, dtype, **kw):
    """The port's SGD steps (lr 0.01, momentum 0.9, wd 1e-4) in ``dtype``:
    losses and a state snapshot after each step."""
    model = _port_model(state).to(dtype)
    opt = make_optimizer("sgd", trainable_parameters(model), LR,
                         momentum=0.9, weight_decay=WD)
    step = make_train_step(model, opt, **kw)
    losses, snaps = [], []
    for x, y in batches:
        losses.append(step(torch.from_numpy(x).to(dtype),
                           torch.from_numpy(y.astype(np.int32))).item())
        snaps.append({k: v.to(torch.float64, copy=True).numpy()
                      for k, v in model.state_dict().items()})
    return model, losses, snaps


def test_fp32_train_steps_match_jax(seeded_pair):
    """One and two fp32 steps of the port's make_train_step against the
    JAX one: losses rtol 1e-3; step 1 within test_train_equivalence.py's
    tight bounds (global l2 0.02 and running stats 0.02 of the update),
    step 2 within its loose ones (:256-260); the ImageNet head
    bit-identical.

    Its per-leaf bound (0.1 of each leaf's update at step 1) is held
    against an fp64 run of the port's step: the port's fp32 step lies
    within it on every leaf. XLA's fp32 step does not: on these weights it
    misses the fp64 one by up to 0.123 of cp.conv_head32.conv.weight's
    update (the port by 0.001), so port and JAX are held within 0.1 of
    each other where JAX's step is within 0.05 of fp64, and elsewhere
    within 0.1 plus JAX's own miss.
    """
    jax_model, variables, state = seeded_pair
    batches = _batches(2, seed=0)
    model, losses, snaps = _port_steps(state, batches, torch.float32)
    _, losses64, snaps64 = _port_steps(state, batches, torch.float64,
                                       ce=_ce_float64)
    init_state = {k: v.double().numpy()
                  for k, v in _port_model(state).state_dict().items()}

    jopt = jax_optim.make_optimizer(
        "sgd", LR, momentum=0.9, weight_decay=WD,
        mask=unused_param_mask(variables["params"]))
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
    for snap, jv, bounds, what in (
            (snaps[0], jvars[0], dict(leaf_tol=None), "port step-1 state"),
            (snaps[1], jvars[1], dict(g_tol=0.40, rs_tol=0.35, leaf_tol=1.2),
             "port step-2 state")):
        model.load_state_dict({k: torch.from_numpy(v).float()
                               for k, v in snap.items()})
        _assert_state_close(jv, model, init_state, what=what, **bounds)
    theirs = torch_io.variables_to_torch_state(jvars[0])
    n_tight = n_loose = 0
    for key, want in theirs.items():
        exact = snaps64[0][key]
        upd = np.abs(exact - init_state[key]).max()
        if upd < 1e-12 or key.endswith(("running_mean", "running_var")):
            continue
        port_err = np.abs(snaps[0][key] - exact).max() / upd
        jax_err = np.abs(want - exact).max() / upd
        port_jax = np.abs(snaps[0][key] - want).max() / upd
        assert port_err < 0.1, (key, port_err)
        tight = jax_err < 0.05
        assert port_jax < (0.1 if tight else 0.1 + jax_err), (
            key, port_jax, jax_err)
        n_tight += tight
        n_loose += not tight
    print(f"step 1: port vs JAX within 0.1 on {n_tight} leaves, within 0.1 "
          f"+ JAX's miss of fp64 on {n_loose}")
    assert n_tight > 4 * n_loose
    # the ImageNet head never moves, here or once read back into JAX
    back = _load_torch_state_into(jax_model, variables, model)
    for key in ("cp.backbone.fc.weight", "cp.backbone.linear.weight",
                "cp.backbone.conv_last.conv.weight",
                "cp.backbone.bn.running_var"):
        np.testing.assert_array_equal(snaps[1][key], init_state[key])
        np.testing.assert_array_equal(
            torch_io.variables_to_torch_state(back)[key], init_state[key])


def test_shuffled_loader_order_matches_jax():
    """Two epochs of (seed, epoch) shuffles with drop_last: the port sees
    the JAX package's batches in the JAX package's order."""
    data = [(np.full((2, 3, 3), i, np.uint8), np.full((2, 3), i, np.uint8))
            for i in range(11)]
    ours = Loader(data, 3, shuffle=True, seed=7, drop_last=True,
                  num_workers=2)
    theirs = JaxLoader(data, 3, shuffle=True, seed=7, drop_last=True,
                       num_workers=2)
    assert len(ours) == len(theirs) == 3
    seen = []
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = [images[:, 0, 0, 0].tolist() for images, _ in ours]
        want = [images[:, 0, 0, 0].tolist() for images, _ in theirs]
        assert got == want
        seen.append(got)
    assert seen[0] != seen[1]
