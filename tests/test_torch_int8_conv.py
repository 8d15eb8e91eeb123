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


def _replay_kernel(x, w_int8, inv, stride, padding):
    """The kernel's plan in numpy, stage by stage: ``pack_weights``' rows,
    and each stage's 32 K columns gathered as csrc/int8_conv.cu's
    ``load`` does (tap-major: one tap, 32 consecutive channels; else
    PyTorch's order with the padded tail zero), quantized, multiplied into
    int64 sums."""
    n, cin, h, w = x.shape
    cout, _, ks, _ = w_int8.shape
    packed = ic.pack_weights(torch.from_numpy(w_int8)).numpy()
    assert packed.shape[0] % ic.TILE_N == 0 and packed.shape[1] % ic.TILE_K \
        == 0
    xq = ic.quantize_activation(torch.from_numpy(x),
                                torch.tensor(inv)).numpy().astype(np.int64)
    oh = (h + 2 * padding - ks) // stride + 1
    ow = (w + 2 * padding - ks) // stride + 1
    m = np.arange(n * oh * ow)
    img, p = m // (oh * ow), m % (oh * ow)
    hi0, wi0 = (p // ow) * stride - padding, (p % ow) * stride - padding
    acc = np.zeros((m.size, packed.shape[0]), np.int64)
    k_total = cin * ks * ks
    for k0 in range(0, packed.shape[1], ic.TILE_K):
        cols = np.arange(k0, k0 + ic.TILE_K)
        if ic.tap_major(cin):
            tap = k0 // cin
            ci = (k0 - tap * cin) + np.arange(ic.TILE_K)
            kh = np.full(ic.TILE_K, tap // ks)
            kw = np.full(ic.TILE_K, tap % ks)
            valid_k = np.ones(ic.TILE_K, bool)
        else:
            ci, r = cols // (ks * ks), cols % (ks * ks)
            kh, kw = r // ks, r % ks
            valid_k = cols < k_total
        ih = hi0[:, None] + kh[None]
        iw = wi0[:, None] + kw[None]
        ok = (valid_k[None] & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w))
        a = np.where(ok, xq[img[:, None], np.minimum(ci, cin - 1)[None],
                            np.clip(ih, 0, h - 1), np.clip(iw, 0, w - 1)], 0)
        acc += a @ packed[:, k0:k0 + ic.TILE_K].astype(np.int64).T
    return acc[:, :cout].reshape(n, oh, ow, cout).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("case", CASES)
def test_port_kernel_plan_replays_to_the_plain_sums(case):
    x, w_int8, _, _, inv = _inputs(case, seed=2)
    stride, padding = case[6], case[7]
    cout = case[4]
    want = _port(x, w_int8, np.ones(cout, np.float32),
                 np.zeros(cout, np.float32), inv, stride, padding, False)
    got = _replay_kernel(x, w_int8, inv, stride, padding)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))


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
