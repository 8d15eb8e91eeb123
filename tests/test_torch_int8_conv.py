"""The int8 conv's plain version against the JAX package, on the CPU.

``ops/cuda/int8_conv.py::int8_conv_reference`` is held against JAX
``ops/quantize.py::int8_conv_epilogue`` (:108) on the same inputs: the
quantized activations and the int32 sums bit for bit (read through the
epilogue with ``out_mul`` 1, bias 0 and no ReLU, exact since the test sums
stay below 2^24), and the full epilogue within 1e-6 relative (XLA may
contract the multiply and add into one FMA; the port's kernel and plain
version do not). The kernel's K order and padding (``pack_weights``) and
its stage-by-stage gather are replayed in numpy, bit for bit against the
plain version: no compiler for the card is at hand here, so the kernel's
plan is checked in Python, its CUDA on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dasemanticsegmentationaml_tpu.ops import quantize as jq
from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic

#: (N, Cin, H, W, Cout, kernel, stride, padding): 3x3 s1, 3x3 s2, 1x1,
#: Cin 3 (the stem: K = 27, not a multiple of 32), Cout below a tile, a
#: ragged pixel tile
CASES = (
    (2, 32, 9, 13, 64, 3, 1, 1),
    (2, 64, 10, 12, 32, 3, 2, 1),
    (1, 64, 7, 9, 96, 1, 1, 0),
    (2, 3, 17, 15, 32, 3, 2, 1),
    (1, 40, 6, 7, 16, 3, 1, 1),
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(case, seed=0):
    n, cin, h, w, cout, ks, _, _ = case
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, cin, h, w)) * 2).astype(np.float32)
    w_int8 = rng.integers(-127, 128, (cout, cin, ks, ks)).astype(np.int8)
    out_mul = rng.uniform(1e-4, 1e-2, cout).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    inv = np.float32(127.0 / np.abs(x).max())
    return x, w_int8, out_mul, bias, inv


def _jax(x, w_int8, out_mul, bias, inv, stride, padding, relu):
    quant = {"w_int8": jnp.asarray(w_int8.transpose(2, 3, 1, 0)),
             "out_mul": jnp.asarray(out_mul), "bias": jnp.asarray(bias),
             "in_inv_scale": jnp.asarray(inv)}
    y = jq.int8_conv_epilogue(jnp.asarray(x.transpose(0, 2, 3, 1)), quant,
                              stride, padding, relu=relu, dtype=jnp.float32)
    return np.asarray(y).transpose(0, 3, 1, 2)


def _port(x, w_int8, out_mul, bias, inv, stride, padding, relu,
          out_dtype=torch.float32):
    return ic.int8_conv_reference(
        torch.from_numpy(x), torch.from_numpy(w_int8),
        torch.from_numpy(out_mul), torch.from_numpy(bias),
        torch.tensor(inv), stride, padding, relu, out_dtype)


@pytest.mark.parametrize("case", CASES)
def test_port_int8_sums_equal_jax(case):
    x, w_int8, out_mul, bias, inv = _inputs(case)
    stride, padding = case[6], case[7]
    xq = ic.quantize_activation(torch.from_numpy(x), torch.tensor(inv))
    want_q = np.asarray(jq.quantize_activation(jnp.asarray(x),
                                               jnp.asarray(inv)))
    np.testing.assert_array_equal(xq.numpy(), want_q)
    ones, zeros = np.ones_like(out_mul), np.zeros_like(bias)
    got = _port(x, w_int8, ones, zeros, inv, stride, padding, False)
    want = _jax(x, w_int8, ones, zeros, inv, stride, padding, False)
    assert np.abs(want).max() < 2**24
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.round(got.numpy()))


@pytest.mark.parametrize("case", CASES)
def test_port_int8_epilogue_matches_jax(case):
    x, w_int8, out_mul, bias, inv = _inputs(case, seed=1)
    stride, padding = case[6], case[7]
    got = _port(x, w_int8, out_mul, bias, inv, stride, padding, True)
    want = _jax(x, w_int8, out_mul, bias, inv, stride, padding, True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    assert (got.numpy() >= 0).all()
    bf16 = _port(x, w_int8, out_mul, bias, inv, stride, padding, True,
                 torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, got.to(torch.bfloat16))


def _split_steps(p, split):
    """The K stages split ``split`` of plan ``p`` sums (csrc/int8_conv.cu:
    ``s_begin`` .. ``s_end``)."""
    return range(split * p.ksteps // p.splits,
                 (split + 1) * p.ksteps // p.splits)


def _replay_kernel(x, w_int8, inv, stride, padding, sms):
    """The kernels' plan in numpy: the prologue's scratch
    (``quantize_input_reference``: NHWC int8, channels zero-padded, or
    im2col rows), ``pack_weights``' rows, and each split's stages walked as
    csrc/int8_conv.cu's ``load_stage`` does: a loader's 16-byte K piece j
    = 4 s + chunk decoded once to (tap, channel piece) at the split's first
    stage, then advanced by 4 pieces a stage; taps outside the image,
    pieces past the taps and output channels past Cout zero-filled. Each
    split's int64 partial sums, then their sum."""
    n, cin, h, w = x.shape
    cout, _, ks, _ = w_int8.shape
    p = ic.plan(n, cin, h, w, cout, ks, stride, padding, sms)
    xt = torch.from_numpy(x)
    scratch = ic.quantize_input_reference(xt, torch.tensor(inv), ks, stride,
                                          padding).numpy().astype(np.int64)
    assert scratch.shape == (n, p.in_h, p.in_w, p.cq * ic.PIECE)
    packed = ic.pack_weights(torch.from_numpy(w_int8)).numpy()
    assert packed.shape == (cout, p.kpad) and p.kpad % ic.TILE_K == 0
    assert p.ksteps * ic.TILE_K == p.kpad
    m = np.arange(n * p.out_h * p.out_w)
    img, pix = m // (p.out_h * p.out_w), m % (p.out_h * p.out_w)
    ih0 = (pix // p.out_w) * p.stride - p.pad_h
    iw0 = (pix % p.out_w) * p.stride - p.pad_w
    chunks = ic.TILE_K // ic.PIECE
    steps = [s for split in range(p.splits) for s in _split_steps(p, split)]
    assert steps == list(range(p.ksteps)), "the splits must cover K once"
    partials = np.zeros((p.splits, m.size, cout), np.int64)
    for split in range(p.splits):
        span = _split_steps(p, split)
        assert len(span) >= 1
        for ch in range(chunks):
            tap, c16 = divmod(span.start * chunks + ch, p.cq)
            for s in span:
                kh, kw = divmod(tap, p.ks)
                ih, iw = ih0 + kh, iw0 + kw
                ok = ((tap < p.ks * p.ks) & (ih >= 0) & (ih < p.in_h)
                      & (iw >= 0) & (iw < p.in_w))
                a = np.where(ok[:, None], scratch[
                    img, np.clip(ih, 0, p.in_h - 1), np.clip(iw, 0, p.in_w - 1),
                    c16 * ic.PIECE:(c16 + 1) * ic.PIECE], 0)
                k0 = s * ic.TILE_K + ch * ic.PIECE
                partials[split] += a @ packed[:, k0:k0 + ic.PIECE].astype(
                    np.int64).T
                c16 += chunks
                while c16 >= p.cq:
                    c16 -= p.cq
                    tap += 1
    acc = partials.sum(0)
    return acc.reshape(n, p.out_h, p.out_w, cout).transpose(0, 3, 1, 2), p


#: the replay's cases beyond ``CASES``: K split nine ways (36 stages) at
#: 132 SMs, and a ragged second tile of output channels
REPLAY_CASES = CASES + (
    (1, 256, 6, 5, 40, 3, 1, 1),
    (1, 96, 5, 5, 200, 3, 2, 1),
)


@pytest.mark.parametrize("sms", [132, 2])
@pytest.mark.parametrize("case", REPLAY_CASES)
def test_port_kernel_plan_replays_to_the_plain_sums(case, sms):
    """The plans at 132 and at 2 SMs split K differently (up to nine
    ways)."""
    x, w_int8, _, _, inv = _inputs(case, seed=2)
    stride, padding = case[6], case[7]
    cout = case[4]
    want = _port(x, w_int8, np.ones(cout, np.float32),
                 np.zeros(cout, np.float32), inv, stride, padding, False)
    got, p = _replay_kernel(x, w_int8, inv, stride, padding, sms)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))
    assert p.im2col == (case[1] < ic.PIECE)


def _edge_values(shape, seed):
    """Values that land, after the fp32 multiply by 127 / 100, on ties at
    .5 (odd and even), NaN, +-inf, past +-127 and in between."""
    rng = np.random.default_rng(seed)
    inv = np.float32(127.0 / 100.0)
    ties = (rng.integers(-130, 130, shape) + 0.5) / inv
    x = np.where(rng.random(shape) < 0.5, ties.astype(np.float32),
                 (rng.standard_normal(shape) * 150).astype(np.float32))
    flat = x.reshape(-1)
    flat[::7] = np.nan
    flat[3::11] = np.inf
    flat[5::13] = -np.inf
    flat[1::17] = 1e30
    flat[2::19] = -1e30
    return x.astype(np.float32), inv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_prologue_plain_version_equals_quantize_activation(dtype):
    """NHWC mode (Cin 20, padded to 32): each value is
    ``quantize_activation``'s: ties to even, NaN to 0, +-inf and values
    past +-127 clamped; the padded channels are 0."""
    x, inv = _edge_values((2, 20, 5, 7), 0)
    xt = torch.from_numpy(x).to(dtype)
    got = ic.quantize_input_reference(xt, torch.tensor(inv), 3, 1, 1)
    want = ic.quantize_activation(xt, torch.tensor(inv)).permute(0, 2, 3, 1)
    assert got.shape == (2, 5, 7, 32) and got.dtype == torch.int8
    assert torch.equal(got[..., :20], want)
    assert not got[..., 20:].any()
    q = want.numpy().astype(np.int64)
    assert (q[np.isnan(x.transpose(0, 2, 3, 1))] == 0).all()
    assert set(np.unique(q[np.isinf(x.transpose(0, 2, 3, 1))])) <= {-127, 127}
    if dtype == torch.float32:
        v = np.float32(x.transpose(0, 2, 3, 1)) * inv
        fin = np.isfinite(v)
        np.testing.assert_array_equal(
            q[fin], np.clip(np.round(v[fin]), -127, 127).astype(np.int64))


def test_port_prologue_plain_version_im2col_rows():
    """im2col mode (the stem: Cin 3, 3x3, stride 2): each output pixel's
    row is K = (kh, kw, ci) of the zero-padded quantized input, as
    ``F.unfold`` takes it, then zeros to 32 bytes."""
    x, inv = _edge_values((2, 3, 9, 12), 1)
    xt = torch.from_numpy(x)
    got = ic.quantize_input_reference(xt, torch.tensor(inv), 3, 2, 1)
    q = ic.quantize_activation(xt, torch.tensor(inv))
    cols = F.unfold(q.double(), 3, padding=1, stride=2)  # (n, ci*9, L)
    cols = cols.reshape(2, 3, 9, 5, 6).permute(0, 3, 4, 2, 1).reshape(
        2, 5, 6, 27)
    assert got.shape == (2, 5, 6, 32)
    assert torch.equal(got[..., :27].double(), cols)
    assert not got[..., 27:].any()


#: the 35 int8 blocks of BiSeNet-STDC813 under ``--quantize_filter all``
#: at batch 8, 512x1024, as 24 distinct shapes: (N, Cin, H, W, Cout,
#: kernel, stride, padding) -> (im2col, cq, kpad, tile_n, tiles_m,
#: tiles_n, splits) on 132 SMs
ALL_SHAPES = {
    (8, 3, 512, 1024, 32, 3, 2, 1): (True, 2, 64, 32, 8192, 1, 1),
    (8, 32, 256, 512, 64, 3, 2, 1): (False, 2, 320, 64, 2048, 1, 1),
    (8, 64, 128, 256, 128, 1, 1, 0): (False, 4, 64, 128, 2048, 1, 1),
    (8, 128, 64, 128, 64, 3, 1, 1): (False, 8, 1152, 64, 512, 1, 1),
    (8, 64, 64, 128, 32, 3, 1, 1): (False, 4, 576, 32, 512, 1, 1),
    (8, 32, 64, 128, 32, 3, 1, 1): (False, 2, 320, 32, 512, 1, 1),
    (8, 256, 64, 128, 128, 1, 1, 0): (False, 16, 256, 128, 512, 1, 1),
    (8, 256, 64, 128, 256, 1, 1, 0): (False, 16, 256, 128, 512, 2, 1),
    (8, 256, 32, 64, 128, 3, 1, 1): (False, 16, 2304, 128, 128, 1, 2),
    (8, 128, 32, 64, 64, 3, 1, 1): (False, 8, 1152, 64, 128, 1, 2),
    (8, 64, 32, 64, 64, 3, 1, 1): (False, 4, 576, 64, 128, 1, 2),
    (8, 512, 32, 64, 256, 1, 1, 0): (False, 32, 512, 128, 128, 2, 1),
    (8, 512, 32, 64, 512, 1, 1, 0): (False, 32, 512, 128, 128, 4, 1),
    (8, 512, 16, 32, 256, 3, 1, 1): (False, 32, 4608, 128, 32, 2, 4),
    (8, 256, 16, 32, 128, 3, 1, 1): (False, 16, 2304, 128, 32, 1, 8),
    (8, 128, 16, 32, 128, 3, 1, 1): (False, 8, 1152, 128, 32, 1, 4),
    (8, 1024, 16, 32, 512, 1, 1, 0): (False, 64, 1024, 128, 32, 4, 2),
    (8, 1024, 1, 1, 128, 1, 1, 0): (False, 64, 1024, 128, 1, 1, 4),
    (8, 1024, 16, 32, 128, 3, 1, 1): (False, 64, 9216, 128, 32, 1, 8),
    (8, 128, 32, 64, 128, 3, 1, 1): (False, 8, 1152, 128, 128, 1, 2),
    (8, 512, 32, 64, 128, 3, 1, 1): (False, 32, 4608, 128, 128, 1, 2),
    (8, 128, 64, 128, 128, 3, 1, 1): (False, 8, 1152, 128, 512, 1, 1),
    (8, 384, 64, 128, 256, 1, 1, 0): (False, 24, 384, 128, 512, 2, 1),
    (8, 256, 64, 128, 256, 3, 1, 1): (False, 16, 2304, 128, 512, 2, 1),
}


@pytest.mark.parametrize("shape", list(ALL_SHAPES))
def test_port_int8_plan_for_the_all_filter_shapes(shape):
    p = ic.plan(*shape, 132)
    assert (p.im2col, p.cq, p.kpad, p.tile_n, p.tiles_m, p.tiles_n,
            p.splits) == ALL_SHAPES[shape]
    assert 1 <= p.splits <= p.ksteps
    if p.splits > 1:
        assert p.tiles_m * p.tiles_n < ic.WAVE_BLOCKS * 132
        assert p.ksteps // p.splits >= ic.MIN_SPLIT_STEPS


@pytest.mark.parametrize("shape,want", [
    # conv_avg's pooled map: M = 8, one tile, K split four ways
    ((8, 1024, 1, 1, 128, 1, 1, 0), dict(m=8, tiles_m=1, splits=4)),
    # Cout 19 and 32 take the narrowest tile, 96 the widest
    ((1, 40, 9, 13, 19, 3, 1, 1), dict(tile_n=32, cq=3, kpad=448)),
    ((2, 64, 10, 12, 32, 3, 2, 1), dict(tile_n=32, out_h=5, out_w=6)),
    ((3, 64, 7, 11, 96, 1, 1, 0), dict(tile_n=128, tiles_n=1)),
    # Cin 3 (im2col: K = 27 -> 32 bytes, one stage), and Cin 3 at 1x1
    ((1, 3, 37, 29, 32, 3, 2, 1), dict(im2col=True, cq=2, kpad=64, ks=1,
                                        in_h=19, in_w=15, ksteps=1)),
    ((2, 3, 8, 8, 16, 1, 1, 0), dict(im2col=True, cq=1, kpad=64)),
    # a ragged last pixel tile: 7 * 11 * 3 = 231 pixels
    ((3, 64, 7, 11, 64, 3, 1, 1), dict(m=231, tiles_m=2)),
    # Cin 15 is the largest im2col row: 135 -> 144 bytes
    ((1, 15, 4, 4, 8, 3, 1, 1), dict(im2col=True, cq=9, kpad=192)),
    # an empty batch: no tile, nothing to split
    ((0, 64, 8, 8, 64, 3, 1, 1), dict(m=0, tiles_m=0, splits=1)),
])
def test_port_int8_plan_edges(shape, want):
    p = ic.plan(*shape, 132)
    assert {k: getattr(p, k) for k in want} == want
    assert p.cq * ic.PIECE <= ic.IM2COL_MAX_K or not p.im2col


def test_port_int8_conv_on_cpu_is_the_plain_version():
    case = CASES[0]
    x, w_int8, out_mul, bias, inv = _inputs(case, seed=3)
    w = torch.from_numpy(w_int8)
    args = (torch.from_numpy(x), w, ic.pack_weights(w),
            torch.from_numpy(out_mul), torch.from_numpy(bias),
            torch.tensor(inv), 1, 1)
    before = ic.LAUNCHES
    got = ic.int8_conv(*args)
    assert ic.LAUNCHES == before
    assert torch.equal(got, _port(x, w_int8, out_mul, bias, inv, 1, 1, True))


def test_port_int8_conv_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 8, 4, 4)
    w = torch.zeros(4, 8, 3, 3, dtype=torch.int8)
    rest = (ic.pack_weights(w), torch.ones(4), torch.zeros(4),
            torch.tensor(1.0), 1, 1)
    with pytest.raises(ValueError, match="square kernel 1 or 3"):
        ic.int8_conv(x, torch.zeros(4, 8, 5, 5, dtype=torch.int8), *rest)
    with pytest.raises(ValueError, match="do not take"):
        ic.int8_conv(torch.zeros(1, 6, 4, 4), w, *rest)
    with pytest.raises(TypeError, match="int8"):
        ic.int8_conv(x, w.float(), *rest)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ic.int8_conv(x.half(), w, *rest)
    with pytest.raises(ValueError, match="unsupported device"):
        ic.int8_conv(x.to("meta"), w, *rest)
