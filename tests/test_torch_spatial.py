"""The height-sharded mesh's parts (``parallel/spatial.py``) on the CPU.

* ``check_spatial_height`` against the JAX function on a grid of heights
  and mesh sizes (tests/test_parallel.py:264-276): the same heights pass,
  the same fail, with the same words.
* Each banded op at world 2 and 3 (a 1 x world mesh of gloo ranks,
  ``tests/torch_ranks.py::banded_ops``), forward and the gradient of
  sum(y * dy), against the op on the whole tensor, in float64 within
  1e-10 of each side's largest value: the convolutions of every (k, s,
  p) the three models use (STDC's 3x3 s1 / s2 and 1x1, the depthwise
  avd conv, D's 4x4 s2 p1 and its pointwise 1x1 with padding 1), the
  AvgPool2d(3, 2, 1), the global mean, the x2 nearest upsample, the
  align_corners resize, and the three discriminators' chains (the
  depthwise ones with unequal bands; BN in eval mode here, the train
  mode's sync BN is held by the step tests).
* The halo plans: every send is the matching receive.
* OHEM over a mesh's bands (1 x 2 and 2 x 2): the shares sum to JAX's
  ``ohem_cross_entropy`` on the whole batch (rtol 1e-5) and the bands'
  gradients assemble into JAX's (1e-5 of its max), in both branches.
* The windowed plain ``upsample_argmax`` against the same rows of the
  full plain version, bit for bit (fp32, bf16, bands whose taps reach a
  row past either edge), and the windowed plain CE with the global count:
  the bands' shares sum to the full loss (rtol 1e-6), the gradients they
  put into the logits equal the full one's (1e-6 of its max); the
  backward kernel's band plan from a window's taps (replayed in numpy,
  ``tests/test_torch_fused_ce.py::_band_backward``) gathers the window's
  rows of the tap matrices.

About 40 s alone on the CPU (four spawns of ranks).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_fused_ce import _band_backward, _tap_matrix
from torch_ranks import (SPATIAL_OPS, banded_ops, ohem_bands, run_ranks,
                         spatial_cotangent, spatial_full, spatial_input,
                         spatial_op)

from dasemanticsegmentationaml_tpu.ops import losses as jax_losses
from dasemanticsegmentationaml_tpu.parallel.mesh import (
    check_spatial_height as jax_check_spatial_height)
from dasemanticsegmentationaml_tpu_torch.ops import resize
from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc
from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua
from dasemanticsegmentationaml_tpu_torch.ops.resize import RowWindow
from dasemanticsegmentationaml_tpu_torch.parallel.spatial import (
    Rows, align_corners_needs, check_spatial_height, halo_plan, layer_rows,
    window_needs)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------- check_spatial_height

@pytest.mark.parametrize("height", [128, 1024, 116, 32, 64, 96, 192, 100,
                                    512, 1, 6])
@pytest.mark.parametrize("size", [1, 2, 3, 4, 8])
def test_check_spatial_height_is_jaxs(height, size):
    def outcome(fn):
        try:
            fn(height, size)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(check_spatial_height) == outcome(jax_check_spatial_height)


# ------------------------------------------------------------ banded ops

@pytest.fixture(scope="module")
def banded_runs(tmp_path_factory):
    """world -> every banded op's results at that world, run once."""
    cache = {}

    def runs(world):
        if world not in cache:
            cache[world] = run_ranks(
                banded_ops, tmp_path_factory.mktemp(f"banded{world}"),
                world=world, names=list(SPATIAL_OPS))
        return cache[world]
    return runs


def _close(got, want, what):
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err <= 1e-10, (what, err)


@pytest.mark.parametrize("name", list(SPATIAL_OPS))
@pytest.mark.parametrize("world", [2, 3])
def test_banded_op_matches_the_whole_op_in_float64(banded_runs, world, name):
    ranks = [r[name] for r in banded_runs(world)]
    op = spatial_op(name)
    x = torch.from_numpy(spatial_input(name)).requires_grad_()
    y = spatial_full(name, op, x)
    dy = torch.from_numpy(spatial_cotangent(name, y.shape))
    (y * dy).sum().backward()
    y = y.detach().numpy()
    if SPATIAL_OPS[name][0] == "mean":
        for got, *_ in ranks:          # every rank holds the whole mean
            _close(got, y, f"{name} y")
    else:
        bands = [rows for _, rows, _, _ in ranks]
        assert bands[0][0] == 0 and bands[-1][1] == y.shape[2]
        assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
        _close(np.concatenate([r[0] for r in ranks], 2), y, f"{name} y")
    _close(np.concatenate([r[2] for r in ranks], 2), x.grad.numpy(),
           f"{name} dx")
    if op is not None:
        for key, p in op.named_parameters():
            _close(sum(r[3][key] for r in ranks), p.grad.numpy(),
                   f"{name} d{key}")


def test_discriminator_bands_are_unequal(banded_runs):
    """The DW D's pointwise padding moves its bands off the even split;
    the FC D's stay even."""
    dw = [r["dw_discriminator"][1] for r in banded_runs(2)]
    assert dw[0][1] - dw[0][0] != dw[1][1] - dw[1][0]
    rows = Rows.even(96, 3)
    rows = layer_rows(rows, 48, 4, 2, 1)
    assert rows == Rows.even(48, 3)
    assert layer_rows(rows, 50, 1, 1, 1) == Rows((0, 17, 33, 50))


@pytest.mark.parametrize("rows,n_out,k,s,p", [
    (Rows.even(24, 2), 12, 3, 2, 1), (Rows.even(24, 3), 24, 3, 1, 1),
    (Rows((0, 17, 33, 50)), 25, 4, 2, 1), (Rows((0, 9, 17, 25)), 27, 1, 1, 1),
    (Rows.even(64, 4), 32, 4, 2, 1)])
def test_halo_plans_pair_every_send_with_its_receive(rows, n_out, k, s, p):
    out = layer_rows(rows, n_out, k, s, p)
    needs = window_needs(out, k, s, p)
    parts = len(rows.bounds) - 1
    plans = [halo_plan(rows, needs, t, tuple(range(parts)))
             for t in range(parts)]
    for t, plan in enumerate(plans):
        lo, hi = needs[t]
        assert plan.length == hi - lo
        covered = np.zeros(hi - lo, bool)
        if plan.own is not None:
            a, b, at = plan.own
            covered[at:at + b - a] = True
        for peer, a, b in plan.recv:
            assert not covered[a:b].any()
            covered[a:b] = True
            sent = [(x, y) for q, x, y in plans[peer].send if q == t]
            assert sent == [(a + lo - rows.bounds[peer],
                             b + lo - rows.bounds[peer])]
        inside = np.arange(lo, hi)
        assert (covered == ((inside >= 0) & (inside < rows.n))).all()


@pytest.mark.parametrize("data,spatial", [(1, 2), (2, 2)])
def test_ohem_over_bands_is_jaxs_on_the_whole_batch(tmp_path, data,
                                                    spatial):
    rng = np.random.default_rng(5)
    logits = (3.0 * rng.standard_normal((4, 19, 16, 32))).astype(np.float32)
    labels = np.where(rng.uniform(size=(4, 16, 32)) <
                      np.array([0.05, 0.05, 0.4, 0.4])[:, None, None], 255,
                      rng.integers(0, 19, (4, 16, 32))).astype(np.int32)
    cases = {"top-k": (100.0, 700), "above": (2.0, 700)}
    ranks = run_ranks(ohem_bands, tmp_path, world=data * spatial,
                      spatial=spatial, logits=logits, labels=labels,
                      cases=cases)
    for name, (threshold, keep) in cases.items():
        want, grad = jax.value_and_grad(
            lambda v: jax_losses.ohem_cross_entropy(
                jnp.moveaxis(v, 1, -1), jnp.asarray(labels), threshold,
                keep))(jnp.asarray(logits))
        got = sum(r[name][0] for r in ranks)
        np.testing.assert_allclose(got, float(want), rtol=1e-5, err_msg=name)
        grad = np.asarray(grad)
        assembled = np.concatenate([np.concatenate(
            [ranks[d * spatial + s][name][1] for s in range(spatial)], 2)
            for d in range(data)], 0)
        np.testing.assert_allclose(assembled, grad, rtol=0,
                                   atol=1e-5 * np.abs(grad).max(),
                                   err_msg=name)


# ------------------------------------------------------ windowed kernels

def _bands(out_h, parts):
    rows = Rows.even(out_h, parts)
    return [rows.band(s) for s in range(parts)]


WINDOW_CASES = [
    # (h, w, H, W, bands): the eval head's stride-8 logits of a band, a
    # window's taps reaching past its band's edges, single rows, the ends
    (16, 8, 128, 64, _bands(128, 2) + _bands(128, 4)),
    (12, 10, 96, 80, _bands(96, 3) + [(1, 2), (47, 49), (95, 96)]),
    (7, 9, 50, 37, [(0, 1), (3, 17), (17, 41), (41, 50), (24, 25)]),
    (9, 7, 9, 7, _bands(9, 3)),
]


def _window(h, H, y0, y1):
    lo, hi = resize.window_rows(y0, y1, h, H)
    return RowWindow(y0, y1, h, H, lo), hi


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,H,W,bands", WINDOW_CASES)
def test_windowed_upsample_argmax_is_the_full_rows(h, w, H, W, bands,
                                                   dtype):
    rng = np.random.default_rng(h * 100 + w)
    x = rng.standard_normal((2, 19, h, w)).astype(np.float32)
    x[1] = np.round(x[1] * 2)            # ties in the second image
    logits = torch.from_numpy(x).to(dtype)
    full = ua.upsample_argmax(logits, (H, W))
    crossed = False
    for y0, y1 in bands:
        window, hi = _window(h, H, y0, y1)
        # the rows the even band of logits would hold, beside the halo
        crossed |= window.base < y0 * h // H or hi > -(-y1 * h // H)
        got = ua.upsample_argmax(logits[:, :, window.base:hi].contiguous(),
                                 (y1 - y0, W), window=window)
        assert torch.equal(got, full[:, y0:y1]), (y0, y1)
    if H > h:
        assert crossed


@pytest.mark.parametrize("h,w,H,W,parts", [
    (16, 8, 128, 64, 2), (16, 8, 128, 64, 4), (12, 10, 96, 80, 3),
    (7, 9, 49, 37, 7)])
def test_windowed_ce_shares_sum_to_the_full_loss(h, w, H, W, parts):
    """Each band's share is its CE sum over the global count: the bands'
    shares sum to the full mean, and the gradients they put into the
    logits (each band's window, halo included) to the full gradient."""
    rng = np.random.default_rng(h)
    x = torch.from_numpy(rng.standard_normal((2, 19, h, w))
                         .astype(np.float32))
    labels = torch.from_numpy(np.where(
        rng.uniform(size=(2, H, W)) < 0.3, 255,
        rng.integers(0, 19, (2, H, W))).astype(np.int32))
    full_x = x.clone().requires_grad_()
    full = fc.cross_entropy_upsampled(full_x, labels, (H, W))
    full.backward()
    n_valid = (labels != 255).sum().float().clamp_min(1.0)
    band_x = x.clone().requires_grad_()
    total = 0.0
    for y0, y1 in _bands(H, parts):
        window, hi = _window(h, H, y0, y1)
        share = fc.cross_entropy_upsampled(
            band_x[:, :, window.base:hi].contiguous(),
            labels[:, y0:y1].contiguous(), (y1 - y0, W), window=window,
            n_valid=n_valid)
        share.backward()
        total += float(share.detach())
    np.testing.assert_allclose(total, float(full.detach()), rtol=1e-6)
    grad = full_x.grad.numpy()
    np.testing.assert_allclose(band_x.grad.numpy(), grad, rtol=0,
                               atol=1e-6 * np.abs(grad).max())


@pytest.mark.parametrize("h,w,H,W,k", [
    (16, 8, 128, 64, 2), (12, 10, 96, 80, 3), (7, 9, 50, 37, 1),
    (64, 4, 512, 32, 8)])
def test_windowed_band_plan_gathers_the_windows_tap_rows(h, w, H, W, k):
    """The backward's plan from a window's rebased taps (its own cache
    key) gives the window's rows of Mr^T P Mc over the band's logits."""
    for parts in (2, 3):
        if H % parts:
            continue
        for y0, y1 in _bands(H, parts):
            window, hi = _window(h, H, y0, y1)
            hb = hi - window.base
            kk = min(k, hb)
            plan = fc.band_rows(hb, y1 - y0, kk, window)
            assert plan[0] == 0 and plan[-1] == y1 - y0
            rng = np.random.default_rng(y0)
            p = rng.standard_normal((1, 2, y1 - y0, W))
            got = _band_backward(p, hb, w, kk, window)
            mr = _tap_matrix(h, H)[y0:y1, window.base:hi]
            dense = np.einsum("yi,bcyx,xj->bcij", mr, p, _tap_matrix(w, W))
            np.testing.assert_allclose(got, dense, rtol=0, atol=1e-12)


def test_align_corners_needs_are_the_window_rows():
    rows = Rows.even(96, 3)
    needs = align_corners_needs(12, rows)
    for s, (lo, hi) in enumerate(needs):
        assert (lo, hi) == resize.window_rows(*rows.band(s), 12, 96)
    with pytest.raises(ValueError, match="starts below"):
        resize.window_taps(RowWindow(32, 64, 12, 96, needs[1][0] + 1))
