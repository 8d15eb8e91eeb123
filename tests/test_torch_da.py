"""The port's domain-adaptation pieces against the JAX package, on the CPU.

The three discriminators (parameter counts, output shapes, eval- and
train-mode forwards, running statistics, gradients), ``bce_with_logits``,
and whole fp32 DA steps of ``train/adversarial.py::make_da_step`` are held
against their JAX counterparts. Weights cross over as in
tests/test_torch_train.py: seeded numpy values in the JAX variables,
``variables_to_torch_state`` to the port. The steps are compared with
tests/test_train_equivalence.py's update-relative step-1 bounds (:378-380),
with the per-leaf bound on G held against an fp64 run of the port where
XLA's fp32 step misses it, as tests/test_torch_train.py does.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from test_torch_models import seeded_variables
from test_torch_train import _ce_float64
from test_train_equivalence import _batches

from dasemanticsegmentationaml_tpu.models.bisenet import BiSeNet as JaxBiSeNet
from dasemanticsegmentationaml_tpu.models.bisenet import unused_param_mask
from dasemanticsegmentationaml_tpu.models.discriminator import (
    build_discriminator as jax_build_discriminator)
from dasemanticsegmentationaml_tpu.ops import losses as jax_losses
from dasemanticsegmentationaml_tpu.ops import schedules as jax_schedules
from dasemanticsegmentationaml_tpu.train import (create_train_state,
                                                 make_da_step as
                                                 jax_make_da_step)
from dasemanticsegmentationaml_tpu.train import optim as jax_optim
from dasemanticsegmentationaml_tpu.utils import torch_io
from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
    BiSeNet, trainable_parameters)
from dasemanticsegmentationaml_tpu_torch.models.discriminator import (
    build_discriminator)
from dasemanticsegmentationaml_tpu_torch.ops import losses, schedules
from dasemanticsegmentationaml_tpu_torch.train.adversarial import (
    make_da_step)
from dasemanticsegmentationaml_tpu_torch.train.optim import make_optimizer
from dasemanticsegmentationaml_tpu_torch.utils.weights import (
    load_reference_state)

H, W = 64, 128
LR_G, LR_D, LAMBDA, WD = 0.01, 1e-3, 1e-3, 5e-4

#: (depthwise, batch_norm) -> (parameters, NCHW output at 1x19x64x128);
#: tests/test_models.py:101-103
D_KINDS = {(False, False): (2_781_121, (1, 1, 2, 4)),
           (True, False): (190_340, (1, 1, 3, 5)),
           (True, True): (193_194, (1, 1, 3, 5))}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """As tests/test_torch_fused_ce.py: torch on one CPU thread beside
    jaxlib, for the tight bounds below."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _d_pair(depthwise, batch_norm, seed=0):
    """A JAX discriminator's seeded variables and the port's carrying them."""
    jax_d = jax_build_discriminator(19, depthwise, batch_norm)
    variables = seeded_variables(
        lambda: jax_d.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 19))),
        seed=seed)
    d = build_discriminator(19, depthwise, batch_norm)
    state = torch_io.variables_to_torch_state(variables)
    load_reference_state(d, state, strict=True)
    return jax_d, variables, d


def _softmax_maps(seed, n=2):
    logits = np.random.default_rng(seed).standard_normal(
        (n, H, W, 19)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("kind", list(D_KINDS))
def test_discriminator_matches_jax(kind):
    """Counts and shapes as the JAX modules; eval and train forwards
    within 1e-5 of max|ref|; running statistics after a train forward
    within 1e-5 of each leaf's max."""
    n_params, out_shape = D_KINDS[kind]
    jax_d, variables, d = _d_pair(*kind)
    assert sum(p.numel() for p in d.parameters()) == n_params
    with torch.no_grad():
        assert d.eval()(torch.zeros(1, 19, H, W)).shape == out_shape
    x = _softmax_maps(1)
    with torch.no_grad():
        got_eval = d.eval()(_nchw(x))
        got_train = d.train()(_nchw(x))
    want_eval = np.asarray(jax_d.apply(variables, jnp.asarray(x), train=False))
    want_train, mutated = jax_d.apply(variables, jnp.asarray(x), train=True,
                                      mutable=["batch_stats"])
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=0, atol=1e-5 * np.abs(want).max())
    stats = torch_io.variables_to_torch_state(
        {"batch_stats": mutated.get("batch_stats", {})})
    assert len(stats) == (16 if kind == (True, True) else 0)
    ours = d.state_dict()
    for key, want in stats.items():
        np.testing.assert_allclose(ours[key].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=key)


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_with_logits_matches_jax(target):
    """fp32: the loss within 1e-6 (relative), the gradient within 1e-6
    of its max."""
    x = (4.0 * np.random.default_rng(2).standard_normal((2, 1, 9, 17))
         ).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    got = losses.bce_with_logits(xt, target)
    got.backward()
    want, g_want = jax.value_and_grad(
        lambda v: jax_losses.bce_with_logits(v, target))(jnp.asarray(x))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    g_want = np.asarray(g_want)
    np.testing.assert_allclose(xt.grad.numpy(), g_want, rtol=0,
                               atol=1e-6 * np.abs(g_want).max())
    ref = F.binary_cross_entropy_with_logits(
        torch.from_numpy(x), torch.full_like(torch.from_numpy(x), target))
    np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-6)


def test_constant_lr_matches_jax():
    ours, theirs = schedules.ConstantLR(1e-3), jax_schedules.ConstantLR(1e-3)
    ours.fast_forward(3)
    assert [ours(e) for e in range(5)] == [theirs(e) for e in range(5)]


@pytest.mark.parametrize("kind", list(D_KINDS))
def test_discriminator_gradients_match_jax(kind):
    """Train-mode D, BCE against the source label: every parameter's
    gradient within 1e-4 of its max, except the conv biases that feed a
    BN, whose gradient is zero up to rounding
    (tests/test_train_equivalence.py:398-406): there both sides stay
    below 1e-5."""
    jax_d, variables, d = _d_pair(*kind, seed=3)
    x = _softmax_maps(4)
    loss = losses.bce_with_logits(d.train()(_nchw(x)), 0.0)
    loss.backward()

    def loss_fn(params):
        out, _ = jax_d.apply({**variables, "params": params}, jnp.asarray(x),
                             train=True, mutable=["batch_stats"])
        return jax_losses.bce_with_logits(out, 0.0)

    grads = torch_io.variables_to_torch_state(
        {"params": jax.grad(loss_fn)(variables["params"]), "batch_stats": {}})
    feeds_bn = kind == (True, True)
    n_real = n_zero = 0
    for name, p in d.named_parameters():
        got, want = p.grad.numpy(), np.asarray(grads[name])
        if feeds_bn and name.endswith("bias") and name.startswith("conv"):
            assert np.abs(got).max() < 1e-5 and np.abs(want).max() < 1e-5
            n_zero += 1
            continue
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
        n_real += 1
    assert n_zero == (8 if feeds_bn else 0)
    assert n_real == len(list(d.parameters())) - n_zero


# ---------------------------------------------------------------- DA steps

@pytest.fixture(scope="module")
def g_vars():
    jax_g = JaxBiSeNet(n_classes=19, dtype=jnp.float32)
    variables = seeded_variables(
        lambda: jax_g.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
                           method=JaxBiSeNet.full_init), seed=0)
    return jax_g, variables


#: (step mode, d_head, (depthwise, batch_norm))
STEP_CASES = {"interleaved-head0-dwbn": ("interleaved", 0, (True, True)),
              "combined-head2-fc": ("combined", 2, (False, False)),
              "interleaved-head0-fc": ("interleaved", 0, (False, False))}


def _port_run(g_state, d_state, kind, mode, d_head, batches, dtype, n_steps,
              **kw):
    """The port's DA steps in ``dtype``: metrics and (G, D) snapshots after
    each step; ``phase_moves`` records conv_out16's weight after every SGD
    step of G."""
    g = BiSeNet(19)
    load_reference_state(g, g_state, strict=True)
    d = build_discriminator(19, *kind)
    load_reference_state(d, d_state, strict=True)
    g, d = g.to(dtype).train(), d.to(dtype).train()
    g_opt = make_optimizer("sgd", trainable_parameters(g), LR_G,
                           momentum=0.9, weight_decay=WD)
    d_opt = make_optimizer("adam", d.parameters(), LR_D, betas=(0.9, 0.99))
    moves = []
    sgd_step = g_opt.step

    def recording_step(*a, **k):
        out = sgd_step(*a, **k)
        moves.append(g.conv_out16.conv_out.weight.detach().clone())
        return out

    g_opt.step = recording_step
    step = make_da_step(g, d, g_opt, d_opt, lambda_adv=LAMBDA, d_head=d_head,
                        step_mode=mode, **kw)
    metrics, snaps = [], []
    for x, y, xt in batches[:n_steps]:
        m = step(torch.from_numpy(x).to(dtype),
                 torch.from_numpy(y.astype(np.int32)),
                 torch.from_numpy(xt).to(dtype))
        metrics.append({k: v.item() for k, v in m.items()})
        snaps.append(tuple({k: v.to(torch.float64, copy=True).numpy()
                            for k, v in net.state_dict().items()}
                           for net in (g, d)))
    return metrics, snaps, moves


@pytest.fixture(scope="module", params=list(STEP_CASES))
def da_runs(request, g_vars):
    """Two fp32 DA steps of JAX and of the port from the same weights and
    batches, and one fp64 step of the port."""
    mode, d_head, kind = STEP_CASES[request.param]
    jax_g, gv = g_vars
    jax_d, dv, _ = _d_pair(*kind, seed=5)
    g_state = torch_io.variables_to_torch_state(gv)
    d_state = torch_io.variables_to_torch_state(dv)
    batches = _batches(2, seed=1, with_target=True)

    g_opt_j = jax_optim.make_optimizer(
        "sgd", LR_G, momentum=0.9, weight_decay=WD,
        mask=unused_param_mask(gv["params"]))
    d_opt_j = jax_optim.make_optimizer("adam", LR_D, betas=(0.9, 0.99))
    gs, ds = create_train_state(gv, g_opt_j), create_train_state(dv, d_opt_j)
    jstep = jax_make_da_step(jax_g, jax_d, g_opt_j, d_opt_j,
                             lambda_adv=LAMBDA, d_head=d_head, donate=False,
                             step_mode=mode)
    jmetrics, jsnaps = [], []
    for x, y, xt in batches:
        gs, ds, m = jstep(gs, ds, jnp.asarray(x.transpose(0, 2, 3, 1)),
                          jnp.asarray(y.astype(np.int32)),
                          jnp.asarray(xt.transpose(0, 2, 3, 1)), LR_G, LR_D)
        jmetrics.append({k: float(v) for k, v in m.items()})
        jsnaps.append(tuple({"params": jax.device_get(st.params),
                             "batch_stats": jax.device_get(st.batch_stats)}
                            for st in (gs, ds)))
    port = _port_run(g_state, d_state, kind, mode, d_head, batches,
                     torch.float32, 2)
    port64 = _port_run(g_state, d_state, kind, mode, d_head, batches,
                       torch.float64, 2, ce=_ce_float64)
    init = tuple({k: np.asarray(v, np.float64) for k, v in s.items()}
                 for s in (g_state, d_state))
    return dict(case=request.param, mode=mode, kind=kind, init=init,
                jax=(jmetrics, jsnaps), port=port, port64=port64,
                g_state=g_state, d_state=d_state)


def test_da_step_losses_match_jax(da_runs):
    """Step 1: the seg loss within rtol 1e-3 of JAX (measured 2e-6);
    loss_D1 (lambda-scaled) and loss_adv within rtol 5e-3 with the FC
    discriminator, and within 5e-2 (test_train_equivalence.py:371-375's
    bound against the reference) with the DW+BN one, whose train-mode BN
    over near-constant channels of a 2-image batch amplifies rounding:
    there the port's own fp32 and fp64 steps differ by 2.6e-2 on loss_D1.
    Step 2, after two SGD updates of G and two Adam updates of D: each
    within the same rtol of JAX plus JAX's own miss of the port's fp64
    run (fp32 chaos: both fp32 seg losses miss fp64 by about 5e-4), and
    the port's seg loss within 1e-3 of its fp64 run."""
    jmetrics, _ = da_runs["jax"]
    metrics, _, _ = da_runs["port"]
    metrics64, _, _ = da_runs["port64"]
    adv_rtol = 5e-2 if da_runs["kind"] == (True, True) else 5e-3
    for key, rtol in (("loss", 1e-3), ("loss_G", 1e-3), ("loss_D1", adv_rtol),
                      ("loss_adv", adv_rtol)):
        got = [m[key] for m in metrics]
        want = [m[key] for m in jmetrics]
        exact = [m[key] for m in metrics64]
        print(f"{da_runs['case']} {key}: port {got}, JAX {want}, port fp64 "
              f"{exact}")
        assert np.isfinite(got).all()
        assert abs(got[0] - want[0]) <= rtol * abs(want[0]), key
        jax_miss = abs(want[1] - exact[1])
        assert abs(got[1] - want[1]) <= rtol * abs(want[1]) + jax_miss, key
    assert abs(metrics[1]["loss"] - metrics64[1]["loss"]) <= \
        1e-3 * metrics64[1]["loss"]
    assert abs(metrics[0]["loss"] - metrics64[0]["loss"]) <= \
        1e-5 * metrics64[0]["loss"]


def _global_l2(theirs, ours, init, skip=()):
    """||ours - theirs|| / ||theirs - init|| over the parameters (not the
    running statistics or ``skip``): test_train_equivalence.py:142's
    global ratio."""
    sq_diff = sq_upd = 0.0
    for key, want in theirs.items():
        if key.endswith(("running_mean", "running_var",
                         "num_batches_tracked")) or key in skip:
            continue
        sq_diff += float(np.sum((ours[key] - want) ** 2))
        sq_upd += float(np.sum((want - init[key]) ** 2))
    return float(np.sqrt(sq_diff / max(sq_upd, 1e-30)))


def test_da_step1_state_matches_jax(da_runs):
    """After step 1, update-relative (test_train_equivalence.py:378-380):
    G within global l2 0.02 of JAX and D within 0.25 (its first Adam step
    sign-saturates, so D has no per-leaf bound; the DW+BN D's conv biases
    that feed a BN are left out: their gradient is zero up to rounding and
    Adam turns it into +-lr coin flips), frozen leaves equal. The per-leaf
    bound, 0.1 of each leaf's update, is held against the port's fp64
    step: the port's fp32 step lies within it on every G parameter, and
    port and JAX within it of each other where JAX's step is within 0.05
    of fp64, elsewhere within 0.1 plus JAX's own miss. D is held the same
    way on its global l2: port and JAX within 0.25 plus JAX's miss of
    fp64, and the port's fp32 step within 0.25 of fp64 or, where XLA's
    fp32 step misses fp64 by more, no further off than XLA's (DW+BN D:
    port 0.297, JAX 0.331; the seeded BN scales leave more near-zero
    gradient elements for Adam's first step to flip). Running
    statistics: in the interleaved step their phase-2 update sees G after
    its phase-1 update, which fp32 rounding moves by up to 0.1 of a leaf's
    update, so single deep statistics miss fp64 by up to 0.23 of theirs in
    the port and 0.35 in JAX; they are held to a global l2 of 0.05 and to
    0.3 per leaf (an update-order fault moves every statistic by O(1))."""
    _, jsnaps = da_runs["jax"]
    _, snaps, _ = da_runs["port"]
    _, snaps64, _ = da_runs["port64"]
    g_init, d_init = da_runs["init"]
    theirs_g = torch_io.variables_to_torch_state(jsnaps[0][0])
    theirs_d = torch_io.variables_to_torch_state(jsnaps[0][1])
    bn_fed = {f"conv{i}_{s}.bias" for i in range(1, 5) for s in "dp"} \
        if da_runs["kind"] == (True, True) else set()
    g_l2 = _global_l2(theirs_g, snaps[0][0], g_init)
    d_l2 = _global_l2(theirs_d, snaps[0][1], d_init, skip=bn_fed)
    d_jax_miss = _global_l2(snaps64[0][1], theirs_d, d_init, skip=bn_fed)
    d_port_miss = _global_l2(snaps64[0][1], snaps[0][1], d_init, skip=bn_fed)
    print(f"\n{da_runs['case']}: global l2 G {g_l2:.4f}; D {d_l2:.4f} (port "
          f"vs fp64 {d_port_miss:.4f}, JAX vs fp64 {d_jax_miss:.4f})")
    assert g_l2 < 0.02, g_l2
    assert d_port_miss < max(0.25, d_jax_miss), (d_port_miss, d_jax_miss)
    assert d_l2 < 0.25 + d_jax_miss
    n_tight = n_loose = n_frozen = 0
    rs_diff = rs_upd = 0.0
    for theirs, ours, exact, init in (
            (theirs_g, snaps[0][0], snaps64[0][0], g_init),
            (theirs_d, snaps[0][1], snaps64[0][1], d_init)):
        for key, want in theirs.items():
            upd = np.abs(exact[key] - init[key]).max()
            if upd < 1e-12:
                np.testing.assert_array_equal(ours[key], init[key])
                np.testing.assert_array_equal(want, init[key])
                n_frozen += 1
                continue
            port_err = np.abs(ours[key] - exact[key]).max() / upd
            jax_err = np.abs(want - exact[key]).max() / upd
            port_jax = np.abs(ours[key] - want).max() / upd
            if key.endswith(("running_mean", "running_var")):
                rs_diff += float(np.sum((ours[key] - want) ** 2))
                rs_upd += float(np.sum((want - init[key]) ** 2))
                assert port_err < 0.3 and port_jax < 0.3 + jax_err, (
                    key, port_err, port_jax)
                continue
            if theirs is theirs_d:
                continue
            assert port_err < 0.1, (key, port_err)
            tight = jax_err < 0.05
            assert port_jax < (0.1 if tight else 0.1 + jax_err), (
                key, port_jax, jax_err)
            n_tight += tight
            n_loose += not tight
    rs_l2 = float(np.sqrt(rs_diff / max(rs_upd, 1e-30)))
    print(f"{da_runs['case']}: G leaves within 0.1 of JAX {n_tight}, within "
          f"0.1 plus JAX's miss {n_loose}; {n_frozen} frozen; running "
          f"statistics global l2 {rs_l2:.4f}")
    assert rs_l2 < 0.05
    assert n_tight > 4 * n_loose and n_frozen >= 7


def test_phase2_applies_momentum_and_decay_to_the_aux_heads(da_runs):
    """torch<2.0 ``zero_grad`` semantics (JAX adversarial.py:26-33): in the
    interleaved step's phase 2 the conv_out16 head gets a zero gradient,
    and SGD still moves it by momentum and weight decay; under torch 2.x's
    default ``set_to_none=True`` it would stay put. The move equals
    -lr * (0.9 * buf + wd * p1), with buf = (p0 - p1) / lr from phase 1,
    and the head ends where JAX's does (0.1 of its update, where a skipped
    phase 2 would miss by about 0.47)."""
    if da_runs["mode"] != "interleaved":
        pytest.skip("the combined step has one SGD step")
    _, _, moves = da_runs["port"]
    key = "conv_out16.conv_out.weight"
    p0 = torch.from_numpy(da_runs["g_state"][key]).double()
    p1, p2 = moves[0].double(), moves[1].double()
    buf = (p0 - p1) / LR_G
    expect = p1 - LR_G * (0.9 * buf + WD * p1)
    assert (p2 - p1).abs().max() > 0.5 * (p1 - p0).abs().max()
    np.testing.assert_allclose(p2.numpy(), expect.numpy(), rtol=0,
                               atol=1e-4 * (p1 - p0).abs().max().item())
    _, jsnaps = da_runs["jax"]
    want = torch_io.variables_to_torch_state(jsnaps[0][0])[key]
    upd = np.abs(want - p0.numpy()).max()
    assert np.abs(p2.numpy() - want).max() / upd < 0.1
