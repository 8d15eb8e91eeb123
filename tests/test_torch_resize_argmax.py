"""The port's resize ops and fused upsample+argmax against the JAX package.

The plain PyTorch version ``upsample_argmax_reference`` (what the wrapper
runs on a CPU tensor) is held against the JAX XLA reference
``_xla_reference`` (upsample_argmax.py:80) and the Pallas body in
interpret mode, as tests/test_pallas.py runs it. Both sides use the same
float64-derived taps, so random-normal logits agree exactly; integer
(tie-heavy) logits may flip a pixel where exact class ties are broken by
the JAX dot's fused multiply-add, hence the 1e-5 bound there.
``F.interpolate`` computes its taps in fp32, so it is held within 2e-3.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from dasemanticsegmentationaml_tpu.ops import resize as jresize
from dasemanticsegmentationaml_tpu.ops.pallas.upsample_argmax import (
    _xla_reference, upsample_argmax as jax_upsample_argmax)
from dasemanticsegmentationaml_tpu_torch.ops import resize
from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua

FULL = ((2, 64, 128, 19), (512, 1024))


def _logits(shape, seed, tie_heavy=False):
    """NHWC numpy logits, as the JAX functions take them."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if tie_heavy:
        x = np.round(x * 4).astype(np.float32)
    return x


def _port(x_nhwc, out_hw, dtype=torch.float32):
    t = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous().to(dtype)
    return ua.upsample_argmax(t, out_hw).numpy()


def _xla(x_nhwc, out_hw):
    return np.asarray(_xla_reference(jnp.asarray(x_nhwc), out_hw))


def _interpret(x_nhwc, out_hw, dtype=jnp.float32):
    return np.asarray(jax_upsample_argmax(jnp.asarray(x_nhwc, dtype), out_hw,
                                          force="interpret"))


@pytest.mark.parametrize("in_size,out_size", [
    (64, 512), (128, 1024), (7, 37), (13, 50), (1, 9), (9, 1), (16, 16)])
def test_taps_are_the_jax_taps(in_size, out_size):
    for got, want in zip(resize._align_corners_taps(in_size, out_size),
                         jresize._align_corners_taps(in_size, out_size)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(
        resize._nearest_indices(in_size, out_size),
        jresize._nearest_indices(in_size, out_size))


@pytest.mark.parametrize("in_hw,out_hw", [
    ((1, 1), (4, 8)),     # global-context broadcast
    ((2, 4), (4, 8)),     # the context path's 2x upsamples
    ((3, 5), (7, 9)),     # non-integer ratio
])
def test_upsample_nearest_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(0).standard_normal(
        (2, *in_hw, 6)).astype(np.float32)
    want = np.asarray(jresize.upsample_nearest(jnp.asarray(x), out_hw))
    got = resize.upsample_nearest(
        torch.from_numpy(x).permute(0, 3, 1, 2), out_hw)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_resize_bilinear_matches_jax():
    x = _logits((2, 8, 16, 5), 0)
    want = np.asarray(jresize.resize_bilinear_align_corners(
        jnp.asarray(x), (37, 64)))
    got = resize.resize_bilinear_align_corners(
        torch.from_numpy(x).permute(0, 3, 1, 2), (37, 64))
    # F.interpolate derives its taps in fp32, JAX in float64
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,out_hw", [
    FULL,
    ((1, 7, 13, 19), (37, 50)),     # odd sizes
    ((1, 9, 11, 19), (45, 61)),     # no multiple of 8
    ((2, 64, 128, 19), (64, 128)),  # identity
    ((2, 1, 13, 19), (37, 50)),     # h = 1
    ((1, 5, 1, 19), (9, 1)),        # w = 1, W = 1
])
def test_reference_matches_xla_exactly(shape, out_hw):
    x = _logits(shape, 0)
    got = _port(x, out_hw)
    assert got.shape == (shape[0], *out_hw) and got.dtype == np.int32
    np.testing.assert_array_equal(got, _xla(x, out_hw))


@pytest.mark.parametrize("shape,out_hw", [FULL, ((1, 8, 16, 19), (32, 64))])
def test_reference_matches_pallas_interpret_exactly(shape, out_hw):
    x = _logits(shape, 2)
    np.testing.assert_array_equal(_port(x, out_hw), _interpret(x, out_hw))


def test_reference_exact_on_separated_logits():
    """tests/test_pallas.py's separated case (seed 1): exact against both."""
    x = _logits((1, 8, 16, 19), 1, tie_heavy=True)
    got = _port(x, (32, 64))
    np.testing.assert_array_equal(got, _xla(x, (32, 64)))
    np.testing.assert_array_equal(got, _interpret(x, (32, 64)))


def test_reference_tie_heavy_full_size():
    shape, out_hw = FULL
    x = _logits(shape, 0, tie_heavy=True)
    got = _port(x, out_hw)
    assert (got != _xla(x, out_hw)).mean() <= 1e-5
    assert (got != _interpret(x, out_hw)).mean() <= 1e-5


@pytest.mark.parametrize("shape,out_hw,tie_heavy", [
    (*FULL, False), ((1, 8, 16, 19), (32, 64), True)])
def test_reference_agrees_with_f_interpolate(shape, out_hw, tie_heavy):
    x = _logits(shape, 1, tie_heavy)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = F.interpolate(t, out_hw, mode="bilinear",
                         align_corners=True).argmax(1).numpy()
    assert (_port(x, out_hw) != want).mean() <= 2e-3


def test_bf16_input_is_widened_exactly():
    """bf16 logits are widened to fp32: the same classes as the fp32 path
    on the widened values (exact), and within the JAX bf16 SPLIT kernel's
    ~16-bit taps (tests/test_pallas.py bounds it at 1e-3)."""
    x = _logits((2, 8, 16, 19), 3) * 4
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    got = _port(x, (32, 64), torch.bfloat16)
    np.testing.assert_array_equal(got, _port(xb, (32, 64)))
    np.testing.assert_array_equal(got, _xla(xb, (32, 64)))
    assert (got != _interpret(x, (32, 64), jnp.bfloat16)).mean() <= 1e-3


def test_cpu_tensor_never_counts_a_launch():
    before = ua.LAUNCHES
    x = _logits((1, 8, 16, 19), 0)
    _port(x, (32, 64))
    _port(x, (32, 64), torch.bfloat16)
    assert ua.LAUNCHES == before


@pytest.mark.parametrize("make,out_hw,exc", [
    (lambda: torch.zeros(19, 8, 16), (32, 64), ValueError),
    (lambda: torch.zeros(1, 19, 8, 16, dtype=torch.float16), (32, 64),
     TypeError),
    (lambda: torch.zeros(1, 16, 8, 19).permute(0, 3, 2, 1), (32, 64),
     ValueError),
    (lambda: torch.zeros(1, 19, 8, 16), (0, 64), ValueError),
    (lambda: torch.zeros(1, 19, 8, 16, device="meta"), (32, 64), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(make, out_hw, exc):
    with pytest.raises(exc):
        ua.upsample_argmax(make(), out_hw)
