"""The port's data-parallel steps at world 2 against the JAX package, on the
CPU.

Two gloo ranks (``tests/torch_ranks.py``: spawned processes that import
no JAX, one torch thread each, a ``file://`` store in ``tmp_path``, a
timeout on every join) each take half of a global batch of
2 x (2 x 3 x 64 x 128) from seeded numpy values; JAX runs on the virtual
CPU devices ``tests/conftest.py`` makes. Weights cross over as in
tests/test_torch_train.py (``seeded_variables`` ->
``variables_to_torch_state``). The labels of rank 1's rows are 40%
ignore (255), rank 0's 5%: an average of the ranks' local CE means then
misses the global mean, the case the sync step's ``n_local / n_global``
scale is for.

* ``SyncBatchNorm2d`` at world 2 against ``nn.BatchNorm2d`` on the
  concatenated batch: outputs, input and parameter gradients, running
  statistics over two steps and the eval forward.
* The sync step (``sync_bn=True``) against JAX ``make_train_step`` on the
  global batch, and against the port's own one-process step on it; the
  per-replica step (``sync_bn=False``) against JAX
  ``make_sharded_train_step(sync_bn=False)`` on 2 virtual devices (rank
  r's BN statistics against JAX shard r's) and against
  ``per_replica_reference`` (one process, a model copy a half, gradients
  averaged); OHEM in both modes, with a threshold that forces the top-k
  branch.
* ``--iter_size 2`` in sync mode against the port's one-process
  accumulator.

The DA steps are in tests/test_torch_parallel_da.py, which shares this
file's weights and batches. Bounds are PERF.md §2's: the train step's
step-1 bounds (loss rtol 1e-3; update-relative global l2 < 0.02, running
statistics < 0.02, each leaf < 0.1 against an fp64 run of the port, with
JAX's own miss of it allowed, as tests/test_torch_train.py).

About 130 s alone on the CPU (JAX's four train steps, 60 s of it).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn as nn

from test_torch_models import seeded_variables
from test_torch_train import _ce_float64
from torch_ranks import (accumulated_steps, ohem_shares,
                         per_replica_reference, run_ranks, sync_bn_layer,
                         train_steps)

from dasemanticsegmentationaml_tpu.models.bisenet import BiSeNet as JaxBiSeNet
from dasemanticsegmentationaml_tpu.models.bisenet import unused_param_mask
from dasemanticsegmentationaml_tpu.models.discriminator import (
    build_discriminator as jax_build_discriminator)
from dasemanticsegmentationaml_tpu.ops import losses as jax_losses
from dasemanticsegmentationaml_tpu.parallel.mesh import (
    create_mesh, make_sharded_train_step as jax_sharded_train_step,
    per_replica_state)
from dasemanticsegmentationaml_tpu.train import create_train_state
from dasemanticsegmentationaml_tpu.train import (
    make_train_step as jax_train_step)
from dasemanticsegmentationaml_tpu.train import optim as jax_optim
from dasemanticsegmentationaml_tpu.utils import torch_io
from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
    BiSeNet, trainable_parameters)
from dasemanticsegmentationaml_tpu_torch.train.optim import make_optimizer
from dasemanticsegmentationaml_tpu_torch.train.supervised import (
    make_train_step)
from dasemanticsegmentationaml_tpu_torch.utils.weights import (
    load_reference_state)

H, W = 64, 128
LR, WD = 0.01, 1e-4
#: forces OHEM's top-k branch: no pixel loss of these weights reaches it
OHEM = {"threshold": 100.0, "keep_num": 5000}
STATS = ("running_mean", "running_var")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one thread beside jaxlib, as tests/test_torch_da.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _global_batch(seed, with_target=False):
    """2 x (2 x 3 x 64 x 128) images; labels 5% ignore in rank 0's rows,
    40% in rank 1's."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 3, H, W)).astype(np.float32)
    frac = np.array([0.05, 0.05, 0.40, 0.40])[:, None, None]
    y = np.where(rng.uniform(size=(4, H, W)) < frac, 255,
                 rng.integers(0, 19, (4, H, W))).astype(np.int32)
    xt = rng.standard_normal((4, 3, H, W)).astype(np.float32)
    return (x, y, xt) if with_target else (x, y)


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded JAX variables of G and the two discriminators, and the
    reference-named files that carry them to the port's ranks."""
    base = tmp_path_factory.mktemp("weights")
    jax_g = JaxBiSeNet(n_classes=19, dtype=jnp.float32)
    gv = seeded_variables(
        lambda: jax_g.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
                           method=JaxBiSeNet.full_init), seed=0)
    g_state = torch_io.variables_to_torch_state(gv)
    g_path = str(base / "g.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                g_state.items()}, g_path)
    ds, d_paths = {}, {}
    for kind in ((False, False), (True, True)):
        jax_d = jax_build_discriminator(19, *kind)
        dv = seeded_variables(
            lambda: jax_d.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, H, W, 19))), seed=5)
        ds[kind] = (jax_d, dv)
        d_paths[kind] = str(base / f"d{int(kind[0])}{int(kind[1])}.pt")
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                    torch_io.variables_to_torch_state(dv).items()},
                   d_paths[kind])
    init_g = {k: np.asarray(v, np.float64) for k, v in g_state.items()}
    return dict(jax_g=jax_g, gv=gv, g_path=g_path, ds=ds, d_paths=d_paths,
                init_g=init_g)


def _jax_torch(variables):
    return {k: np.asarray(v, np.float64) for k, v in
            torch_io.variables_to_torch_state(variables).items()}


def _compare(ours, theirs, init, *, what, g_tol, rs_tol, rs_global=None,
             exact=None, skip=(), leaf_tol=None):
    """``ours`` (the port, reference-named) against ``theirs`` (JAX), both
    after one step from ``init``, relative to the update
    (tests/test_train_equivalence.py:79-147): the parameters' global l2
    within ``g_tol``, each running statistic within ``rs_tol`` of its
    update (and their global l2 within ``rs_global``), each parameter
    within ``leaf_tol`` of its update, the leaves neither side moved
    equal. ``exact``: the port's fp64 step; each parameter
    then also within 0.1 of its update from it, and within 0.1 of JAX's
    where JAX is within 0.05 of it, elsewhere 0.1 plus JAX's miss."""
    sq = up = rs_sq = rs_up = 0.0
    n_tight = n_loose = 0
    for key, want in theirs.items():
        if key in skip:
            continue
        got = ours[key]
        ref = exact[key] if exact is not None else want
        upd = np.abs(ref - init[key]).max()
        if upd < 1e-12:
            np.testing.assert_array_equal(got, init[key], err_msg=key)
            continue
        if key.endswith(STATS):
            err = np.abs(got - want).max() / upd
            assert err < rs_tol, (what, key, err)
            rs_sq += float(np.sum((got - want) ** 2))
            rs_up += float(np.sum((want - init[key]) ** 2))
            continue
        sq += float(np.sum((got - want) ** 2))
        up += float(np.sum((want - init[key]) ** 2))
        if leaf_tol is not None:
            err = np.abs(got - want).max() / upd
            assert err < leaf_tol, (what, key, err)
        if exact is not None:
            port_err = np.abs(got - ref).max() / upd
            jax_err = np.abs(want - ref).max() / upd
            port_jax = np.abs(got - want).max() / upd
            assert port_err < 0.1, (what, key, port_err)
            tight = jax_err < 0.05
            assert port_jax < (0.1 if tight else 0.1 + jax_err), (
                what, key, port_jax, jax_err)
            n_tight += tight
            n_loose += not tight
    g_l2 = float(np.sqrt(sq / max(up, 1e-30)))
    rs_l2 = float(np.sqrt(rs_sq / max(rs_up, 1e-30)))
    print(f"{what}: global l2 {g_l2:.5f}, running statistics {rs_l2:.5f}; "
          f"leaves within 0.1 of JAX {n_tight}, with JAX's miss {n_loose}")
    assert g_l2 < g_tol, (what, g_l2)
    if rs_global is not None:
        assert rs_l2 < rs_global, (what, rs_l2)
    if exact is not None:
        assert n_tight > 4 * n_loose
    return g_l2


# ------------------------------------------------------------- sync BN

def test_sync_batchnorm_at_world_2_matches_batchnorm_on_the_whole_batch(
        tmp_path):
    """Two steps and an eval forward. fp32: outputs and input gradients
    within 1e-5 of their max, the weight and bias gradients summed over
    the ranks within 1e-5 of theirs, the running statistics within 1e-6
    (the unbiased variance by the global count), ``num_batches_tracked``
    equal."""
    rng = np.random.default_rng(3)
    x = (2.0 + 3.0 * rng.standard_normal((6, 5, 7, 9))).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    weight = (1.0 + 0.1 * rng.standard_normal(5)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(5)).astype(np.float32)
    ranks = run_ranks(sync_bn_layer, tmp_path, x=x, weight=weight,
                      bias=bias, dy=dy, steps=2)

    bn = nn.BatchNorm2d(5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    for step in range(2):
        xs = torch.from_numpy(x).requires_grad_()
        bn.zero_grad()
        y = bn(xs)
        (y * torch.from_numpy(dy)).sum().backward()
        for name, want in (("y", y.detach()), ("dx", xs.grad)):
            got = np.concatenate([r["steps"][step][name] for r in ranks])
            np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                       atol=1e-5 * want.abs().max().item(),
                                       err_msg=name)
        for name, want in (("dweight", bn.weight.grad),
                           ("dbias", bn.bias.grad)):
            got = sum(r["steps"][step][name] for r in ranks)
            np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                       atol=1e-5 * want.abs().max().item(),
                                       err_msg=name)
    for r in ranks:
        np.testing.assert_allclose(r["running_mean"],
                                   bn.running_mean.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(r["running_var"], bn.running_var.numpy(),
                                   rtol=1e-6)
        assert r["num_batches_tracked"] == 2
    with torch.no_grad():
        want = bn.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.concatenate([r["eval"] for r in ranks]),
                               want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_sync_ohem_shares_sum_to_jax_ohem_on_the_global_batch(tmp_path):
    """``sync_ohem_cross_entropy`` at world 2 on each rank's rows of a
    (4, 19, 16, 32) logit batch, against JAX ``ohem_cross_entropy`` on
    the whole batch, in both branches: the ranks' shares sum to the loss
    within rtol 1e-5, each rank's logit gradient equals JAX's rows within
    1e-5 of its max."""
    rng = np.random.default_rng(4)
    logits = (3.0 * rng.standard_normal((4, 19, 16, 32))).astype(np.float32)
    labels = np.where(rng.uniform(size=(4, 16, 32)) <
                      np.array([0.05, 0.05, 0.4, 0.4])[:, None, None], 255,
                      rng.integers(0, 19, (4, 16, 32))).astype(np.int32)
    cases = {"top-k": (100.0, 700), "above": (2.0, 700)}
    ranks = run_ranks(ohem_shares, tmp_path, logits=logits, labels=labels,
                      cases=cases)
    for name, (threshold, keep) in cases.items():
        def loss_fn(v):
            return jax_losses.ohem_cross_entropy(
                v, jnp.asarray(labels), threshold, keep)
        want, grad = jax.value_and_grad(
            lambda v: loss_fn(jnp.moveaxis(v, 1, -1)))(jnp.asarray(logits))
        got = sum(r[name][0] for r in ranks)
        np.testing.assert_allclose(got, float(want), rtol=1e-5, err_msg=name)
        grad = np.asarray(grad)
        np.testing.assert_allclose(
            np.concatenate([r[name][1] for r in ranks]), grad, rtol=0,
            atol=1e-5 * np.abs(grad).max(), err_msg=name)


# ---------------------------------------------------------- train steps

TRAIN_CASES = {"sync": (True, None), "replica": (False, None),
               "sync-ohem": (True, OHEM), "replica-ohem": (False, OHEM)}


@pytest.fixture(scope="module")
def train_runs(weights, tmp_path_factory):
    """One step of each case: the two ranks, JAX, and the port's
    one-process references in fp32 and fp64."""
    x, y = _global_batch(0)
    ranks = run_ranks(train_steps, tmp_path_factory.mktemp("train"),
                      state_path=weights["g_path"], x=x, y=y,
                      cases=TRAIN_CASES, lr=LR, wd=WD)
    jax_g, gv = weights["jax_g"], weights["gv"]
    jopt = jax_optim.make_optimizer("sgd", LR, momentum=0.9, weight_decay=WD,
                                    mask=unused_param_mask(gv["params"]))
    mesh = create_mesh(2)
    jax_runs = {}
    for name, (sync_bn, ohem) in TRAIN_CASES.items():
        if sync_bn:
            step = jax_train_step(jax_g, jopt, ohem=ohem, donate=False)
            st, loss = step(create_train_state(gv, jopt), _nhwc(x),
                            jnp.asarray(y), LR)
            jax_runs[name] = (float(loss), [_jax_torch(
                {"params": st.params, "batch_stats": st.batch_stats})])
        else:
            step = jax_sharded_train_step(jax_g, jopt, mesh, sync_bn=False,
                                          ohem=ohem)
            st, loss = step(per_replica_state(create_train_state(gv, jopt),
                                              mesh), _nhwc(x),
                            jnp.asarray(y), LR)
            stats = jax.device_get(st.batch_stats)
            jax_runs[name] = (float(loss), [_jax_torch(
                {"params": st.params,
                 "batch_stats": jax.tree.map(lambda s: s[r], stats)})
                for r in range(2)])
    # the port in one process: the global step (sync) and the per-replica
    # reference, fp32 and fp64
    ref = {}
    for dtype, kw in ((torch.float32, {}), (torch.float64,
                                            {"ce": _ce_float64})):
        model = BiSeNet(19)
        load_reference_state(model, torch.load(weights["g_path"]),
                             strict=True)
        model = model.to(dtype).train()
        opt = make_optimizer("sgd", trainable_parameters(model), LR,
                             momentum=0.9, weight_decay=WD)
        loss = make_train_step(model, opt, **kw)(
            torch.from_numpy(x).to(dtype), torch.from_numpy(y))
        ref[("sync", dtype)] = (float(loss), {
            k: v.detach().to(torch.float64).numpy()
            for k, v in model.state_dict().items()})
        ref[("replica", dtype)] = per_replica_reference(
            weights["g_path"], x, y, LR, WD, dtype=dtype, **kw)
    return dict(ranks=ranks, jax=jax_runs, ref=ref)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_sharded_train_step_matches_jax(train_runs, weights, case):
    """Each rank's loss is the global one, within rtol 1e-3 of JAX's (sync:
    the global batch's; per replica: the mean of the shards' means, as
    JAX's ``pmean``); the ranks' parameters are equal; rank 0's state
    within the step-1 bounds of JAX's, and rank r's BN statistics within
    0.02 of JAX shard r's (per replica) or of JAX's global statistics
    (sync). OHEM cases: the global bounds (their top-k of 5000 pixels
    leaves fewer update elements than the per-leaf bound was set for)."""
    ranks = [r[case] for r in train_runs["ranks"]]
    want_loss, want_states = train_runs["jax"][case]
    init = weights["init_g"]
    sync_bn, ohem = TRAIN_CASES[case]
    exact = None
    if ohem is None:
        exact = train_runs["ref"][("sync" if sync_bn else "replica",
                                   torch.float64)][1]
    for loss, _ in ranks:
        np.testing.assert_allclose(loss, want_loss, rtol=1e-3)
    state0 = ranks[0][1]
    for key, value in ranks[1][1].items():
        if key.endswith(STATS) or key.endswith("num_batches_tracked"):
            continue
        assert value == float(state0[key].sum()), key
    _compare(state0, want_states[0], init, what=f"{case} rank 0",
             g_tol=0.02, rs_tol=0.02, exact=exact)
    want = want_states[0 if sync_bn else 1]
    for key, value in want.items():
        if key.endswith(STATS):
            upd = np.abs(value - init[key]).max()
            err = np.abs(ranks[1][1][key] - value).max()
            assert err <= 0.02 * upd, (case, key, err, upd)


@pytest.mark.parametrize("mode", ["sync", "replica"])
def test_sharded_train_step_matches_the_ports_one_process_step(train_runs,
                                                               weights,
                                                               mode):
    """The ranks against the port in one process on the same batch: the
    sync step against the plain step on the global batch (the ranks sum
    the BN statistics and gradients in another order: loss within rtol
    1e-5, each parameter and statistic within 0.01 of its update); the
    per-replica step against ``per_replica_reference`` (every sum in the
    same order, the gradients scaled by exact halves: loss within rtol
    1e-6, each leaf within 1e-5 of its update), rank r's statistics
    against copy r's."""
    ranks = [r[mode] for r in train_runs["ranks"]]
    ref_loss, ref_state = train_runs["ref"][(mode, torch.float32)][:2]
    tol_loss, tol_leaf = (1e-5, 1e-2) if mode == "sync" else (1e-6, 1e-5)
    np.testing.assert_allclose(ranks[0][0], ref_loss, rtol=tol_loss)
    init = weights["init_g"]
    for key, want in ref_state.items():
        if key.endswith("num_batches_tracked"):
            assert ranks[0][1][key] == want, key
            continue
        upd = max(np.abs(want - init[key]).max(),
                  1e-6 * max(np.abs(want).max(), 1.0))
        err = np.abs(ranks[0][1][key] - want).max() / upd
        assert err < tol_leaf, (mode, key, err)
    if mode == "replica":
        buffers = train_runs["ref"][(mode, torch.float32)][2]
        for r in range(2):
            for key, want in buffers[r].items():
                np.testing.assert_allclose(ranks[r][1][key], want,
                                           rtol=1e-5, atol=1e-7,
                                           err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("world", [1, 2])
def test_sync_step_is_the_global_step_in_float64(weights, tmp_path, world):
    """In float64 the sync step at world 1 and 2 is the plain step on the
    global batch up to rounding: loss within rtol 1e-7 (each rank's share
    ``n_local / n_global`` is an fp32 factor), every parameter and
    statistic within 1e-6 of its update. So the fp32 gaps
    (here, and 0.0068-0.0217 of the update on the card, PERF.md §6) are
    the rounding of the E[x^2] - E[x]^2 variance and of the sums' order,
    not another function."""
    x, y = _global_batch(0)
    ranks = run_ranks(train_steps, tmp_path, world=world,
                      state_path=weights["g_path"], x=x, y=y,
                      cases={"sync": (True, None)}, lr=LR, wd=WD, fp64=True)
    model = BiSeNet(19)
    load_reference_state(model, torch.load(weights["g_path"]), strict=True)
    model = model.to(torch.float64).train()
    opt = make_optimizer("sgd", trainable_parameters(model), LR,
                         momentum=0.9, weight_decay=WD)
    loss = float(make_train_step(model, opt, ce=_ce_float64)(
        torch.from_numpy(x).to(torch.float64), torch.from_numpy(y)))
    got_loss, got = ranks[0]["sync"]
    np.testing.assert_allclose(got_loss, loss, rtol=1e-7)
    init = weights["init_g"]
    for key, value in model.state_dict().items():
        want = value.numpy()
        if key.endswith("num_batches_tracked"):
            assert got[key] == want, key
            continue
        upd = max(np.abs(want - init[key]).max(), 1e-12)
        assert np.abs(got[key] - want).max() <= 1e-6 * upd, key


def test_sharded_step_accumulates_as_one_process(weights, tmp_path):
    """``--iter_size 2`` at world 2 (sync): two mini-steps through a
    ``GradientAccumulator`` fed the summed gradients, against the port's
    one-process accumulator on the global batches (held against
    ``optax.MultiSteps`` by tests/test_torch_iter_size.py): losses within
    rtol 1e-5; the step-1 bounds (global l2 < 0.02 of the update, each
    parameter < 0.1, each statistic < 0.02: the ranks' BN takes the
    variance as E[x^2] - E[x]^2, as JAX does, where nn.BatchNorm2d's
    differs in rounding, which an early conv's update carries to 0.01 of
    itself over two mini-steps); the ranks' parameters equal."""
    from dasemanticsegmentationaml_tpu_torch.train.optim import (
        GradientAccumulator)

    batches = [_global_batch(2), _global_batch(3)]
    ranks = run_ranks(accumulated_steps, tmp_path,
                      state_path=weights["g_path"], batches=batches, lr=LR,
                      wd=WD, k=2)
    model = BiSeNet(19)
    load_reference_state(model, torch.load(weights["g_path"]), strict=True)
    model.train()
    opt = make_optimizer("sgd", trainable_parameters(model), LR,
                         momentum=0.9, weight_decay=WD)
    step = make_train_step(model, opt,
                           accumulator=GradientAccumulator(opt, 2))
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in batches]
    np.testing.assert_allclose(ranks[0][0], losses, rtol=1e-5)
    assert ranks[0][0] == ranks[1][0]
    state = {k: v.double().numpy() for k, v in model.state_dict().items()}
    for key, value in state.items():
        if key.endswith("num_batches_tracked"):
            assert ranks[0][1][key] == value, key
        elif not key.endswith(STATS):
            assert ranks[1][1][key] == float(ranks[0][1][key].sum()), key
    _compare(ranks[0][1], {k: v for k, v in state.items()
                           if not k.endswith("num_batches_tracked")},
             weights["init_g"], what="iter_size 2", g_tol=0.02, rs_tol=0.02,
             leaf_tol=0.1)
