"""The port's losses and fused upsample+CE against the JAX package, on the CPU.

The plain PyTorch version ``cross_entropy_upsampled_reference`` (what the
wrapper runs on a CPU tensor) is held against the JAX XLA path
``_xla_reference`` (fused_ce.py:56) in fp32, loss and gradient, and
against the Pallas forward and backward bodies run in interpret mode, as
tests/test_fused_ce.py runs them, within that test's bf16 bounds (the
Pallas kernel rounds its taps to bf16). ``tap_ranges``, the gather form
the CUDA backward uses, is held against the dense tap matrix. The CUDA
kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dasemanticsegmentationaml_tpu.ops import losses as jax_losses
from dasemanticsegmentationaml_tpu.ops.pallas import fused_ce as jax_fc
from dasemanticsegmentationaml_tpu_torch.ops import losses, resize
from dasemanticsegmentationaml_tpu_torch.ops.cuda import build
from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_ce as fc
from dasemanticsegmentationaml_tpu_torch.ops.resize import _align_corners_taps


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The torch side runs on one CPU thread here. With jaxlib loaded in
    the same process, torch's intra-op worker threads now and then compute
    ``exp`` with up to 1.5e-4 relative error (6 of 40 processes measured;
    0 of 40 on one thread), which is far above the bounds below."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(shape_nhwc, out_hw, seed, ignore_frac=0.1, high_frac=0.05):
    """NHWC fp32 logits and int32 labels: ``ignore_frac`` of 255 and
    ``high_frac`` in 19..254 (skipped, not an error)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape_nhwc).astype(np.float32)
    lab_shape = (shape_nhwc[0], *out_hw)
    y = rng.integers(0, 19, lab_shape)
    r = rng.random(lab_shape)
    y = np.where(r < ignore_frac, 255, y)
    y = np.where((r >= ignore_frac) & (r < ignore_frac + high_frac),
                 rng.integers(19, 255, lab_shape), y)
    return x, y.astype(np.int32)


def _port_value_and_grad(fn, x_nhwc, labels, *args):
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous()
    x.requires_grad_()
    loss = fn(x, torch.from_numpy(labels), *args)
    loss.backward()
    return loss.item(), x.grad.permute(0, 2, 3, 1).numpy()


def _jax_value_and_grad(fn, x_nhwc, labels, *args):
    y = jnp.asarray(labels)
    val, grad = jax.value_and_grad(lambda v: fn(v, y, *args))(
        jnp.asarray(x_nhwc))
    return float(val), np.asarray(grad)


def test_reference_matches_jax_xla_path():
    """fp32 both sides, the same float64-derived taps: loss rtol 1e-5,
    gradients within 1e-5 of their max (only rounding order differs)."""
    x, y = _inputs((2, 16, 16, 19), (64, 128), 0)
    got, g_got = _port_value_and_grad(fc.cross_entropy_upsampled, x, y,
                                      (64, 128))
    want, g_want = _jax_value_and_grad(jax_fc._xla_reference, x, y,
                                       (64, 128))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(g_got, g_want, rtol=0,
                               atol=1e-5 * np.abs(g_want).max())
    assert np.abs(g_got).max() > 0


def test_reference_matches_pallas_interpret():
    """The Pallas bodies rounding to bf16: tests/test_fused_ce.py's bounds
    (2e-2 on the loss, 5e-2 of max on the gradients)."""
    x, y = _inputs((2, 16, 16, 19), (64, 128), 2)
    got, g_got = _port_value_and_grad(fc.cross_entropy_upsampled, x, y,
                                      (64, 128))
    want, g_want = _jax_value_and_grad(
        lambda v, lab, hw: jax_fc.cross_entropy_upsampled(
            v, lab, hw, force="interpret"), x, y, (64, 128))
    assert abs(got - want) / abs(want) < 2e-2
    assert np.abs(g_got - g_want).max() / np.abs(g_want).max() < 5e-2


def test_all_ignored_gives_zero_loss_and_grad():
    x, _ = _inputs((1, 8, 16, 19), (32, 128), 3)
    y = np.full((1, 32, 128), 255, np.int32)
    loss, grad = _port_value_and_grad(fc.cross_entropy_upsampled, x, y,
                                      (32, 128))
    assert loss == 0.0
    assert not grad.any()


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_entropy_ignore_matches_jax(seed):
    """Labels 19..254 are skipped like 255; fp32, rtol 1e-6 on the loss,
    1e-6 of max on the gradient."""
    x, y = _inputs((2, 8, 16, 19), (8, 16), seed, 0.2, 0.2)
    got, g_got = _port_value_and_grad(losses.cross_entropy_ignore, x, y)
    want, g_want = _jax_value_and_grad(jax_losses.cross_entropy_ignore, x, y)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(g_got, g_want, rtol=0,
                               atol=1e-6 * np.abs(g_want).max())


@pytest.mark.parametrize("threshold,keep_num", [
    (0.7, 100),      # the keep_num-th loss is above the threshold
    (0.7, 4000),     # below it: mean of the top keep_num
    (50.0, 100),     # no loss above the threshold
])
def test_ohem_matches_jax(threshold, keep_num):
    """Loss rtol 1e-5 and gradient 1e-5 of max, fp32 (sums of up to 4096
    terms in another order)."""
    x, y = _inputs((2, 16, 32, 19), (16, 32), 4)
    x *= 2.0
    got, g_got = _port_value_and_grad(losses.ohem_cross_entropy, x, y,
                                      threshold, keep_num)
    want, g_want = _jax_value_and_grad(jax_losses.ohem_cross_entropy, x, y,
                                       threshold, keep_num)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(g_got, g_want, rtol=0,
                               atol=1e-5 * np.abs(g_want).max())


@pytest.mark.parametrize("in_size,out_size", [
    (64, 1024), (128, 1024), (7, 37), (13, 50), (1, 9), (9, 1), (16, 16),
    (64, 32)])
def test_tap_ranges_gather_the_tap_matrix(in_size, out_size):
    """Summing the lo range with weight 1-t and the hi range with t gives
    column j of the dense interpolation matrix: the backward's gather form
    is the transpose of the forward's taps."""
    _, _, t = _align_corners_taps(in_size, out_size)
    dense = _tap_matrix(in_size, out_size)
    r = resize.tap_ranges(in_size, out_size)
    assert r.shape == (in_size, 4) and r.dtype == np.int32
    gathered = np.zeros_like(dense)
    for j in range(in_size):
        gathered[r[j, 0]:r[j, 1], j] += 1.0 - t[r[j, 0]:r[j, 1]]
        gathered[r[j, 2]:r[j, 3], j] += t[r[j, 2]:r[j, 3]]
    np.testing.assert_allclose(gathered, dense, rtol=0, atol=1e-7)


def _tap_matrix(in_size, out_size):
    lo, hi, t = _align_corners_taps(in_size, out_size)
    dense = np.zeros((out_size, in_size))
    np.add.at(dense, (np.arange(out_size), lo), 1.0 - t)
    np.add.at(dense, (np.arange(out_size), hi), t)
    return dense


def _band_backward(p, h, w, k, window=None):
    """The backward kernel's order of work in numpy (float64), from the
    wrapper's plans: per band of k source rows, the output rows of
    ``band_rows``; per row, each column segment's lo and hi sums, added to
    the left neighbour's hi sum; then the row taps into the band's rows and
    its edge row; the edge rows from the two bands' partials. ``window``:
    ``h`` rows of a band of logits, its rebased taps and plan."""
    b, c, out_h, out_w = p.shape
    lo_y, hi_y, ty = (_align_corners_taps(h, out_h) if window is None
                      else resize.window_taps(window))
    _, hi_x, tx = _align_corners_taps(w, out_w)
    xr = resize.tap_ranges(w, out_w)
    plan = fc.band_rows(h, out_h, k, window)
    n_bands = len(plan) - 1
    dx = np.full((b, c, h, w), np.nan)
    edge_e = np.zeros((b, n_bands, c, w))
    edge_f = np.zeros((b, n_bands, c, w))
    for n in range(n_bands):
        i0, kn = n * k, min(k, h - n * k)
        acc = np.zeros((b, c, k + 1, w))
        for y in range(plan[n], plan[n + 1]):
            tl = np.zeros((b, c, w))
            th = np.zeros((b, c, w + 1))
            for j in range(w):
                x0, x1 = xr[j, 0], xr[j, 1]
                hi = hi_x[x0] if x0 < x1 else j
                seg = p[:, :, y, x0:x1]
                tlo = (seg * (1.0 - tx[x0:x1])).sum(-1)
                thi = (seg * tx[x0:x1]).sum(-1)
                assert hi in (j, j + 1)
                if hi == j:
                    tl[..., j] = tlo + thi
                else:
                    tl[..., j] = tlo
                    th[..., j + 1] = thi
            t = tl + th[..., :w]
            assert 0 <= lo_y[y] - i0 < kn and hi_y[y] - i0 <= kn
            acc[:, :, lo_y[y] - i0] += (1.0 - ty[y]) * t
            acc[:, :, hi_y[y] - i0] += ty[y] * t
        for r in range(kn):
            if r == 0 and n > 0:
                edge_f[:, n] = acc[:, :, 0]
            else:
                dx[:, :, i0 + r] = acc[:, :, r]
        if n + 1 < n_bands:
            assert kn == k
            edge_e[:, n] = acc[:, :, k]
    for n in range(1, n_bands):
        dx[:, :, n * k] = edge_e[:, n - 1] + edge_f[:, n]
    return dx


@pytest.mark.parametrize("h,w,out_hw,k", [
    (128, 8, (1024, 64), 3),     # the train step's heads' rows (1023/127
    (64, 4, (1024, 64), 2),      # and 1023/63 a tap: ragged), narrow
    (37, 50, (7, 13), 4),        # downsampling: rows without taps
    (2, 16, (64, 128), 2),       # h = 2, one band
    (13, 16, (100, 120), 3),     # bands whose edges fall between rows
    (1, 13, (37, 50), 1),        # h = 1
    (5, 1, (9, 1), 2),           # w = 1, one output column
    (9, 7, (9, 7), 4),           # identity
])
def test_band_plan_gathers_the_tap_matrices(h, w, out_hw, k):
    """The backward's band plan and column segments give Mr^T P Mc: every
    output row is walked by one band, every output column by one segment,
    every dX element written once (the edge rows by the edge pass)."""
    out_h, out_w = out_hw
    plan = fc.band_rows(h, out_h, k)
    assert plan.dtype == np.int32 and len(plan) == -(-h // k) + 1
    assert plan[0] == 0 and plan[-1] == out_h and (np.diff(plan) >= 0).all()
    xr = resize.tap_ranges(w, out_w)
    assert xr[0, 0] == 0 and xr[-1, 1] == out_w
    assert (xr[1:, 0] == xr[:-1, 1]).all()
    rng = np.random.default_rng(h * 1000 + w)
    b, c = 2, 3
    p = rng.standard_normal((b, c, out_h, out_w))
    got = _band_backward(p, h, w, k)
    dense = np.einsum("yi,bcyx,xj->bcij", _tap_matrix(h, out_h), p,
                      _tap_matrix(w, out_w))
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-12)


@pytest.mark.parametrize("b,c,h,w,out_h,sms", [
    (8, 19, 128, 64, 1024, 132), (8, 19, 64, 32, 1024, 132),
    (1, 19, 128, 64, 1024, 132), (2, 32, 16, 32, 128, 132),
    (1, 3, 2, 16, 64, 132), (1, 19, 1, 13, 37, 132),
    (1, 19, 37, 50, 7, 132), (8, 19, 256, 256, 2048, 132),
    (1, 32, 8, 360, 64, 132), (1, 19, 8, 700, 64, 132)])
def test_kernel_geometry_fits_the_card(b, c, h, w, out_h, sms):
    """Rows per forward band and (k, rows per pass) of the backward: the
    shared memory fits one block, a band holds at least 2 source rows where
    the shape has them, and the forward keeps two blocks per SM where it
    has the rows."""
    k, rpp = fc.bwd_geometry(b, c, h, w, sms)
    assert 1 <= k <= min(h, fc.MAX_BAND_ROWS) and rpp >= 1
    assert fc.bwd_smem_bytes(c, w, k, rpp) <= fc.SMEM_LIMIT
    if h >= 2 and fc.bwd_smem_bytes(c, w, 2, 1) <= fc.SMEM_LIMIT:
        assert k >= 2
    rows = fc.fwd_rows_per_band(b, out_h, w, sms)
    assert 1 <= rows <= out_h
    assert rows == 1 or b * -(-out_h // rows) >= 2 * sms


def test_geometry_refuses_a_row_that_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        fc.bwd_geometry(1, 32, 8, 1000, 132)


def test_training_after_validation_reuses_the_cached_taps():
    """Validation (inference mode) and the train loss share the cached
    taps of one shape; a train step after a validation must still
    backpropagate through them."""
    from dasemanticsegmentationaml_tpu_torch.ops.cuda.upsample_argmax import (
        upsample_argmax)

    x, y = _inputs((1, 5, 9, 19), (23, 41), 6)
    logits = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        upsample_argmax(logits, (23, 41))
    got, grad = _port_value_and_grad(fc.cross_entropy_upsampled, x, y,
                                     (23, 41))
    assert np.isfinite(got) and np.abs(grad).max() > 0


def test_cpu_tensor_never_counts_a_launch():
    before = (fc.FWD_LAUNCHES, fc.BWD_LAUNCHES)
    x, y = _inputs((1, 4, 8, 19), (16, 32), 5)
    _port_value_and_grad(fc.cross_entropy_upsampled, x, y, (16, 32))
    assert (fc.FWD_LAUNCHES, fc.BWD_LAUNCHES) == before


@pytest.mark.parametrize("make,labels,exc", [
    (lambda: torch.zeros(19, 8, 16), (1, 32, 64), ValueError),
    (lambda: torch.zeros(1, 19, 8, 16, dtype=torch.float16), (1, 32, 64),
     TypeError),
    (lambda: torch.zeros(1, 16, 8, 19).permute(0, 3, 2, 1), (1, 32, 64),
     ValueError),
    (lambda: torch.zeros(1, 19, 8, 16), (1, 32, 63), ValueError),
    (lambda: torch.zeros(1, 19, 8, 16, device="meta"), (1, 32, 64),
     ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(make, labels, exc):
    with pytest.raises(exc):
        fc.cross_entropy_upsampled(
            make(), torch.zeros(labels, dtype=torch.int32), (32, 64))


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    """The card's route has no fallback: with no compiler the build raises
    (it never answers with the plain version)."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library("fused_ce")


class _FakeLibrary:
    """The launchers' symbols of a built csrc/fused_ce.cu, with its
    geometry shifted by ``threads`` and ``smem``."""

    def __init__(self, threads=0, smem=0):
        for name in ("fused_ce_fwd_f32", "fused_ce_fwd_bf16",
                     "fused_ce_bwd_f32", "fused_ce_bwd_bf16"):
            setattr(self, name, lambda *a: 0)
        self.fused_ce_threads = lambda: fc.THREADS + threads
        self.fused_ce_bwd_smem_bytes = (
            lambda *g: fc.bwd_smem_bytes(*g) + smem)


@pytest.mark.parametrize("threads,smem,agrees", [
    (0, 0, True), (32, 0, False), (0, 4, False)])
def test_library_must_share_the_wrappers_geometry(monkeypatch, threads, smem,
                                                  agrees):
    """The wrapper sizes the grids and the shared memory, the source lays
    them out: a library whose thread count or backward shared-memory
    layout differs from the wrapper's is refused when it is loaded."""
    monkeypatch.setattr(fc, "load_library",
                        lambda name: _FakeLibrary(threads, smem))
    fc._library.cache_clear()
    try:
        if agrees:
            assert isinstance(fc._library(), _FakeLibrary)
        else:
            with pytest.raises(RuntimeError, match="disagree"):
                fc._library()
    finally:
        fc._library.cache_clear()
