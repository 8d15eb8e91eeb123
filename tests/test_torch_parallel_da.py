"""The port's data-parallel DA step at world 2 against the JAX package,
on the CPU.

Two gloo ranks (``tests/torch_ranks.py``) each take half of a global
batch of 2 x (2 x 3 x 64 x 128) source and target images (rank 1's
labels 40% ignore, rank 0's 5%; tests/test_torch_parallel.py's weights
and batches) through ``parallel/mesh.py::make_sharded_da_step``, in both
BN modes and both ``step_mode``s: sync against JAX ``make_da_step`` on
the global batch (DW+BN D, which syncs D's BN too), per replica against
JAX ``make_sharded_da_step(sync_bn=False)`` on 2 virtual devices (FC D).
Bounds are PERF.md §2's DA-step bounds (tests/test_torch_da.py).

About 120 s alone on the CPU (JAX's four DA steps, 90 s of it).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_parallel import (STATS, _compare, _global_batch, _jax_torch,
                                 _nhwc, weights)  # noqa: F401 (a fixture)
from torch_ranks import da_steps, run_ranks

from dasemanticsegmentationaml_tpu.models.bisenet import unused_param_mask
from dasemanticsegmentationaml_tpu.parallel.mesh import (
    create_mesh, make_sharded_da_step as jax_sharded_da_step,
    per_replica_state)
from dasemanticsegmentationaml_tpu.train import create_train_state
from dasemanticsegmentationaml_tpu.train import make_da_step as jax_da_step
from dasemanticsegmentationaml_tpu.train import optim as jax_optim

LR_G, LR_D, LAMBDA, WD_G = 0.01, 1e-3, 1e-3, 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one thread beside jaxlib, as tests/test_torch_da.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: name -> (sync_bn, step_mode, d_head, (depthwise, batch_norm))
DA_CASES = {"sync-interleaved-dwbn": (True, "interleaved", 0, (True, True)),
            "sync-combined-head2-dwbn": (True, "combined", 2, (True, True)),
            "replica-interleaved-fc": (False, "interleaved", 0,
                                       (False, False)),
            "replica-combined-fc": (False, "combined", 0, (False, False))}


@pytest.fixture(scope="module")
def da_runs(weights, tmp_path_factory):
    x, y, xt = _global_batch(1, with_target=True)
    ranks = run_ranks(da_steps, tmp_path_factory.mktemp("da"),
                      g_path=weights["g_path"], d_paths=weights["d_paths"],
                      x=x, y=y, xt=xt, cases=DA_CASES, lr_g=LR_G, lr_d=LR_D,
                      lam=LAMBDA, wd=WD_G)
    jax_g, gv = weights["jax_g"], weights["gv"]
    g_opt = jax_optim.make_optimizer("sgd", LR_G, momentum=0.9,
                                     weight_decay=WD_G,
                                     mask=unused_param_mask(gv["params"]))
    d_opt = jax_optim.make_optimizer("adam", LR_D, betas=(0.9, 0.99))
    mesh = create_mesh(2)
    jax_runs = {}
    for name, (sync_bn, mode, d_head, kind) in DA_CASES.items():
        jax_d, dv = weights["ds"][kind]
        gs, ds = create_train_state(gv, g_opt), create_train_state(dv, d_opt)
        args = (_nhwc(x), jnp.asarray(y), _nhwc(xt), LR_G, LR_D)
        if sync_bn:
            step = jax_da_step(jax_g, jax_d, g_opt, d_opt, lambda_adv=LAMBDA,
                               d_head=d_head, donate=False, step_mode=mode)
            gs, ds, m = step(gs, ds, *args)
            untile = [lambda t: t]
        else:
            step = jax_sharded_da_step(jax_g, jax_d, g_opt, d_opt, mesh,
                                       lambda_adv=LAMBDA, d_head=d_head,
                                       sync_bn=False, step_mode=mode)
            gs, ds, m = step(per_replica_state(gs, mesh),
                             per_replica_state(ds, mesh), *args)
            untile = [lambda t, r=r: jax.tree.map(lambda s: s[r], t)
                      for r in range(2)]
        jax_runs[name] = ({k: float(v) for k, v in m.items()}, [
            tuple(_jax_torch({"params": st.params,
                              "batch_stats": u(jax.device_get(
                                  st.batch_stats))}) for st in (gs, ds))
            for u in untile])
    return dict(ranks=ranks, jax=jax_runs,
                init_d={kind: _jax_torch(dv) for kind, (_, dv) in
                        weights["ds"].items()})


@pytest.mark.parametrize("case", list(DA_CASES))
def test_sharded_da_step_matches_jax(da_runs, weights, case):
    """The ranks' metrics are equal, and within PERF.md §2's DA-step bounds
    of JAX's: the seg loss rtol 1e-3; ``loss_D1``, ``loss_adv`` rtol 5e-3
    (DW+BN D: 5e-2). Rank 0's G within global l2 0.02 of JAX's, D within
    0.25 (its first Adam step sign-saturates; the DW+BN D's conv biases
    that feed a BN are left out, tests/test_torch_da.py), each running
    statistic of G and D within 0.3 of its update and their global l2
    within 0.05; per replica, rank 1's statistics against JAX shard 1's
    the same way."""
    sync_bn, mode, d_head, kind = DA_CASES[case]
    ranks = [r[case] for r in da_runs["ranks"]]
    jmetrics, jstates = da_runs["jax"][case]
    assert ranks[0][0] == ranks[1][0]
    adv = 5e-2 if kind == (True, True) else 5e-3
    for key, rtol in (("loss", 1e-3), ("loss_G", 1e-3), ("loss_D1", adv),
                      ("loss_adv", adv)):
        np.testing.assert_allclose(ranks[0][0][key], jmetrics[key],
                                   rtol=rtol, err_msg=key)
    bn_fed = ({f"conv{i}_{s}.bias" for i in range(1, 5) for s in "dp"}
              if kind == (True, True) else set())
    g0, d0 = ranks[0][1], ranks[0][2]
    _compare(g0, jstates[0][0], weights["init_g"], what=f"{case} G",
             g_tol=0.02, rs_tol=0.3, rs_global=0.05)
    _compare(d0, jstates[0][1], da_runs["init_d"][kind], what=f"{case} D",
             g_tol=0.25, rs_tol=0.3, rs_global=0.05, skip=bn_fed)
    for key in g0:
        if not key.endswith(STATS + ("num_batches_tracked",)):
            assert ranks[1][1][key] == float(g0[key].sum()), key
    if not sync_bn:
        for ours, want, init in ((ranks[1][1], jstates[1][0],
                                  weights["init_g"]),
                                 (ranks[1][2], jstates[1][1],
                                  da_runs["init_d"][kind])):
            for key, value in want.items():
                if key.endswith(STATS):
                    upd = np.abs(value - init[key]).max()
                    assert np.abs(ours[key] - value).max() <= 0.3 * upd, key
