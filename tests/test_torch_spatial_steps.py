"""The height-sharded mesh's forward, train and DA steps against the JAX
package's global-batch programs, on the CPU.

The ranks (``tests/torch_ranks.py::spatial_steps``: spawned gloo ranks,
no JAX in them, one torch thread each) take their band of their data
shard of a global batch of 4 x 3 x 128 x 64 (heights 128, as JAX's
spatial tests use; rank 1's data rows 40% ignore, rank 0's 5%), from the
weights of tests/test_torch_parallel.py (``seeded_variables`` ->
``variables_to_torch_state``):

* data 2 x spatial 2: BiSeNet's eval forward (the main head upsampled,
  banded) against JAX's unsharded ``model.apply`` (rtol 5e-3, atol 5e-4:
  JAX's own bound, tests/test_parallel.py:395), and the fused eval
  prediction's bands against the port's one-process prediction (all but
  1e-3 of the pixels);
* the sync train step at 1 x 2 and 2 x 2 against JAX ``make_train_step``
  on the global batch, with the train step's step-1 bounds (PERF.md §2:
  loss rtol 1e-3; update-relative global l2 < 0.02, running statistics
  < 0.02, each leaf within 0.1 of the port's fp64 one-process step, with
  JAX's own miss of it allowed, as tests/test_torch_parallel.py);
* the DA step at 1 x 2, the DW+BN D (interleaved, the main head fed to
  D) and the FC D (combined, the out32 head), against JAX ``make_da_step``
  with PERF.md §2's DA-step bounds.

The ranks' parameters are equal in every case. About 120 s alone on the
CPU (JAX's forward, train step and two DA steps, 80 s of it).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_parallel import (STATS, _compare, _jax_torch, _nhwc,
                                 weights)  # noqa: F401 (a fixture)
from test_torch_train import _ce_float64
from torch_ranks import run_ranks, spatial_steps

from dasemanticsegmentationaml_tpu.models.bisenet import unused_param_mask
from dasemanticsegmentationaml_tpu.train import create_train_state
from dasemanticsegmentationaml_tpu.train import make_da_step as jax_da_step
from dasemanticsegmentationaml_tpu.train import (
    make_train_step as jax_train_step)
from dasemanticsegmentationaml_tpu.train import optim as jax_optim
from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
    BiSeNet, trainable_parameters)
from dasemanticsegmentationaml_tpu_torch.train.evaluate import predict
from dasemanticsegmentationaml_tpu_torch.train.optim import make_optimizer
from dasemanticsegmentationaml_tpu_torch.train.supervised import (
    make_train_step)
from dasemanticsegmentationaml_tpu_torch.utils.weights import (
    load_reference_state)

H, W = 128, 64
LR, WD, LR_D, WD_DA, LAMBDA = 0.01, 1e-4, 1e-3, 5e-4, 1e-3
#: name -> (D kind (depthwise, batch_norm), step_mode, d_head)
DA_CASES = {"da-dwbn-interleaved": ((True, True), "interleaved", 0),
            "da-fc-combined-head2": ((False, False), "combined", 2)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    rng = np.random.default_rng(31)
    x = rng.standard_normal((4, 3, H, W)).astype(np.float32)
    frac = np.array([0.05, 0.05, 0.40, 0.40])[:, None, None]
    y = np.where(rng.uniform(size=(4, H, W)) < frac, 255,
                 rng.integers(0, 19, (4, H, W))).astype(np.int32)
    xt = rng.standard_normal((4, 3, H, W)).astype(np.float32)
    return x, y, xt


def _port_bisenet(weights, dtype=torch.float32):
    model = BiSeNet(19)
    load_reference_state(model, torch.load(weights["g_path"]), strict=True)
    return model.to(dtype)


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    x, y, xt = _batch()
    common = dict(state_path=weights["g_path"], d_paths=weights["d_paths"],
                  x=x, y=y, xt=xt)
    mesh_1x2 = run_ranks(spatial_steps, tmp_path_factory.mktemp("s12"),
                         world=2, spatial=2,
                         cases={"train": None, **DA_CASES}, **common)
    mesh_2x2 = run_ranks(spatial_steps, tmp_path_factory.mktemp("s22"),
                         world=4, spatial=2, cases={"train": None},
                         forward=True, **common)
    jax_g, gv = weights["jax_g"], weights["gv"]
    jopt = jax_optim.make_optimizer("sgd", LR, momentum=0.9, weight_decay=WD,
                                    mask=unused_param_mask(gv["params"]))
    st, loss = jax_train_step(jax_g, jopt, donate=False)(
        create_train_state(gv, jopt), _nhwc(x), jnp.asarray(y), LR)
    jax_runs = {"train": (float(loss), _jax_torch(
        {"params": st.params, "batch_stats": st.batch_stats}))}
    g_opt = jax_optim.make_optimizer("sgd", LR, momentum=0.9,
                                     weight_decay=WD_DA,
                                     mask=unused_param_mask(gv["params"]))
    d_opt = jax_optim.make_optimizer("adam", LR_D, betas=(0.9, 0.99))
    for name, (kind, mode, d_head) in DA_CASES.items():
        jax_d, dv = weights["ds"][kind]
        step = jax_da_step(jax_g, jax_d, g_opt, d_opt, lambda_adv=LAMBDA,
                           d_head=d_head, donate=False, step_mode=mode)
        gs, ds, m = step(create_train_state(gv, g_opt),
                         create_train_state(dv, d_opt), _nhwc(x),
                         jnp.asarray(y), _nhwc(xt), LR, LR_D)
        jax_runs[name] = ({k: float(v) for k, v in m.items()}, tuple(
            _jax_torch({"params": s.params, "batch_stats": s.batch_stats})
            for s in (gs, ds)))
    jax_forward = np.asarray(jax_g.apply(gv, _nhwc(x), train=False)[0])
    # the port's fp64 one-process step: the leaves' yardstick
    model = _port_bisenet(weights, torch.float64).train()
    opt = make_optimizer("sgd", trainable_parameters(model), LR,
                         momentum=0.9, weight_decay=WD)
    make_train_step(model, opt, ce=_ce_float64)(
        torch.from_numpy(x).double(), torch.from_numpy(y))
    exact = {k: v.numpy() for k, v in model.state_dict().items()}
    with torch.no_grad():
        pred = predict(_port_bisenet(weights).eval(), torch.from_numpy(x),
                       True).numpy()
    return dict(ranks={(1, 2): mesh_1x2, (2, 2): mesh_2x2}, jax=jax_runs,
                jax_forward=jax_forward, exact=exact, pred=pred,
                init_d={kind: _jax_torch(dv) for kind, (_, dv) in
                        weights["ds"].items()})


def _assemble(ranks, key, data, spatial, axis):
    """The global tensor from the ranks' bands (rank d * spatial + s)."""
    return np.concatenate([
        np.concatenate([ranks[d * spatial + s][key] for s in range(spatial)],
                       axis) for d in range(data)], 0)


def test_spatial_forward_at_2x2_matches_jax_unsharded(runs):
    ranks = runs["ranks"][(2, 2)]
    got = _assemble(ranks, "forward", 2, 2, 2).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, runs["jax_forward"], rtol=5e-3,
                               atol=5e-4)
    pred = _assemble(ranks, "predict", 2, 2, 1)
    assert (pred == runs["pred"]).mean() >= 0.999


def _params_equal(ranks, case, index):
    """Every rank's parameters equal rank 0's (the other ranks snapshot
    float64 sums, ``tests/torch_ranks.py::_snapshot``)."""
    state0 = ranks[0][case][index]
    for r in ranks[1:]:
        for key, value in r[case][index].items():
            if key.endswith(STATS + ("num_batches_tracked",)):
                continue
            assert value == float(state0[key].sum()), key


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_spatial_train_step_matches_jax_global_step(runs, weights, mesh):
    ranks = runs["ranks"][mesh]
    want_loss, want = runs["jax"]["train"]
    for r in ranks:
        np.testing.assert_allclose(r["train"][0], want_loss, rtol=1e-3)
    _params_equal(ranks, "train", 1)
    _compare(ranks[0]["train"][1], want, weights["init_g"],
             what=f"spatial {mesh} train", g_tol=0.02, rs_tol=0.02,
             exact=runs["exact"])


@pytest.mark.parametrize("case", list(DA_CASES))
def test_spatial_da_step_at_1x2_matches_jax(runs, weights, case):
    ranks = runs["ranks"][(1, 2)]
    kind = DA_CASES[case][0]
    jmetrics, (jg, jd) = runs["jax"][case]
    metrics = ranks[0][case][0]
    assert all(r[case][0] == metrics for r in ranks)
    adv = 5e-2 if kind == (True, True) else 5e-3
    for key, rtol in (("loss", 1e-3), ("loss_G", 1e-3), ("loss_D1", adv),
                      ("loss_adv", adv)):
        np.testing.assert_allclose(metrics[key], jmetrics[key], rtol=rtol,
                                   err_msg=key)
    _params_equal(ranks, case, 1)
    _params_equal(ranks, case, 2)
    bn_fed = ({f"conv{i}_{s}.bias" for i in range(1, 5) for s in "dp"}
              if kind == (True, True) else set())
    _compare(ranks[0][case][1], jg, weights["init_g"], what=f"{case} G",
             g_tol=0.02, rs_tol=0.3, rs_global=0.05)
    _compare(ranks[0][case][2], jd, runs["init_d"][kind], what=f"{case} D",
             g_tol=0.25, rs_tol=0.3, rs_global=0.05, skip=bn_fed)
