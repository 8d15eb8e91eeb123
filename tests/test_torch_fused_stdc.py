"""The port's fused CatBottleneck pieces against the JAX package, on the CPU.

``fold_bn_into_conv`` and ``fold_cat_params`` are held against their JAX
counterparts on the same carried weights (OIHW here, HWIO there). The
plain PyTorch version ``fused_cat_bottleneck_plain``, which the wrapper
runs on a CPU tensor, is held in fp32 against the JAX ``CatBottleneck``
module in eval mode and against the JAX Pallas kernels run in interpret
mode, as tests/test_fused_stdc.py runs them, on that file's two shapes; a
narrow block per stride with odd sizes is held against the module (the
TPU kernels take 8-divisible row counts only). The CUDA kernels run only
on a card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_models import seeded_variables

from dasemanticsegmentationaml_tpu.models.stdcnet import (
    CatBottleneck as JaxCatBottleneck)
from dasemanticsegmentationaml_tpu.ops import norm as jax_norm
from dasemanticsegmentationaml_tpu.ops.pallas import fused_stdc as jax_fs
from dasemanticsegmentationaml_tpu.utils import torch_io
from dasemanticsegmentationaml_tpu_torch.models.stdcnet import CatBottleneck
from dasemanticsegmentationaml_tpu_torch.ops.cuda import build
from dasemanticsegmentationaml_tpu_torch.ops.cuda import fused_stdc as fs
from dasemanticsegmentationaml_tpu_torch.ops.norm import fold_bn_into_conv
from dasemanticsegmentationaml_tpu_torch.utils.weights import (
    load_reference_state)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """As tests/test_torch_fused_ce.py: torch on one CPU thread beside
    jaxlib, for the tight bounds below."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(stride, in_c, out_c, h, w, seed=0):
    """A JAX CatBottleneck's seeded variables and the port's block carrying
    the same weights, in eval mode."""
    jax_block = JaxCatBottleneck(out_planes=out_c, block_num=4, stride=stride,
                                 dtype=jnp.float32)
    variables = seeded_variables(
        lambda: jax_block.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, h, w, in_c))), seed=seed)
    block = CatBottleneck(in_c, out_c, 4, stride).eval()
    load_reference_state(block, torch_io.variables_to_torch_state(variables))
    return jax_block, variables, block


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def test_fold_bn_into_conv_matches_jax():
    """HWIO there, OIHW here: the same values within 1e-6 (relative)."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    cb = rng.standard_normal(16).astype(np.float32)
    scale, bias, mean = (rng.standard_normal(16).astype(np.float32)
                         for _ in range(3))
    var = (0.5 + rng.random(16)).astype(np.float32)
    for conv_bias in (None, cb):
        want_k, want_b = jax_norm.fold_bn_into_conv(
            jnp.asarray(k), None if conv_bias is None else jnp.asarray(cb),
            jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(mean),
            jnp.asarray(var))
        got_k, got_b = fold_bn_into_conv(
            torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
            None if conv_bias is None else torch.from_numpy(cb),
            *(torch.from_numpy(a) for a in (scale, bias, mean, var)))
        want_k = np.asarray(want_k)
        np.testing.assert_allclose(got_k.permute(2, 3, 1, 0).numpy(), want_k,
                                   rtol=0, atol=1e-6 * np.abs(want_k).max())
        np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0,
                                   atol=1e-6 * np.abs(want_b).max())


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_cat_params_matches_jax(stride, dtype):
    """The folded weights agree after the HWIO <-> OIHW transpose: within
    1e-6 in fp32, and within one bf16 rounding of each other in bf16."""
    _, variables, block = _pair(stride, 32, 64, 16, 16)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jax_fs.fold_cat_params(variables["params"],
                                  variables["batch_stats"], stride, jdt)
    got = fs.fold_cat_params(block, tdt)
    assert got.stride == stride and got.dtype == tdt
    pairs = [(got.w1[:, :, 0, 0].t(), want.w1)]
    pairs += [(k.permute(2, 3, 1, 0), w)
              for k, w in ((got.k2, want.k2), (got.k3, want.k3),
                           (got.k4, want.k4))]
    pairs += [(b, w[0]) for b, w in ((got.b1, want.b1), (got.b2, want.b2),
                                     (got.b3, want.b3), (got.b4, want.b4))]
    if stride == 2:
        pairs += [(got.avd_k[:, 0].permute(1, 2, 0), want.avd_k),
                  (got.avd_b, want.avd_b[0])]
    else:
        assert got.avd_k is None and want.avd_k is None
    for g, w in pairs:
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape
        tol = 1e-6 if dtype == "float32" or g.dtype == np.float32 else 2**-8
        np.testing.assert_allclose(g, w, rtol=tol, atol=1e-7)
    for b in (got.b1, got.b2, got.b3, got.b4):
        assert b.dtype == torch.float32


@pytest.mark.parametrize("stride,in_c,out_c,h,w", [
    (1, 64, 64, 16, 16),   # tests/test_fused_stdc.py:17-20
    (2, 32, 64, 32, 32),
    (1, 16, 32, 9, 13),    # narrow, odd height and width
    (2, 16, 32, 11, 7),
])
def test_plain_version_matches_jax(stride, in_c, out_c, h, w):
    """fp32 against the JAX module in eval mode and, where the TPU kernel
    takes the shape, its interpret-mode run: within 1e-4 of max|ref|
    (measured about 1e-6: the same fp32 sums in another order)."""
    jax_block, variables, block = _pair(stride, in_c, out_c, h, w, seed=1)
    x = np.random.default_rng(2).standard_normal(
        (2, h, w, in_c)).astype(np.float32)
    got = fs.fused_cat_bottleneck_plain(_nchw(x), fs.fold_cat_params(
        block, torch.float32)).permute(0, 2, 3, 1).numpy()
    refs = {"module": np.asarray(jax_block.apply(variables, jnp.asarray(x),
                                                 train=False))}
    if jax_fs.supported(x.shape, stride):
        fp = jax_fs.fold_cat_params(variables["params"],
                                    variables["batch_stats"], stride,
                                    jnp.float32)
        refs["interpret"] = np.asarray(jax_fs.fused_cat_bottleneck(
            jnp.asarray(x), fp, interpret=True))
    assert ("interpret" in refs) == (h % 8 == 0)
    for name, want in refs.items():
        assert got.shape == want.shape, name
        err = np.abs(got - want).max() / np.abs(want).max()
        print(f"{name}: max|plain - ref| / max|ref| = {err:.2e}")
        assert err <= 1e-4, (name, err)
    with torch.no_grad():
        module = block(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, module, rtol=0,
                               atol=1e-4 * np.abs(module).max())


@pytest.mark.parametrize("stride", [1, 2])
def test_cpu_tensor_takes_the_plain_version(stride):
    """Bit-identical to the plain version, in fp32 and bf16, and no
    launch is counted."""
    _, _, block = _pair(stride, 16, 32, 8, 8)
    before = (fs.S1_LAUNCHES, fs.S2_LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        fp = fs.fold_cat_params(block, dtype)
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (1, 16, 8, 8)).astype(np.float32)).to(dtype)
        got = fs.fused_cat_bottleneck(x, fp)
        assert got.dtype == dtype and got.shape == (1, 32, 8 // stride,
                                                    8 // stride)
        assert torch.equal(got, fs.fused_cat_bottleneck_plain(x, fp))
    assert (fs.S1_LAUNCHES, fs.S2_LAUNCHES) == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, _, block = _pair(2, 16, 32, 8, 8)
    fp = fs.fold_cat_params(block, torch.float32)
    x = torch.zeros(1, 16, 8, 8)
    with pytest.raises(TypeError):       # dtype other than the weights'
        fs.fused_cat_bottleneck(x.bfloat16(), fp)
    with pytest.raises(ValueError):      # channels
        fs.fused_cat_bottleneck(torch.zeros(1, 8, 8, 8), fp)
    with pytest.raises(ValueError):      # layout
        fs.fused_cat_bottleneck(
            torch.zeros(1, 8, 8, 16).permute(0, 3, 1, 2), fp)
    with pytest.raises(ValueError):      # device
        fs.fused_cat_bottleneck(torch.zeros(1, 16, 8, 8, device="meta"), fp)
    with pytest.raises(ValueError):      # block_num other than 4
        fs.fold_cat_params(CatBottleneck(16, 32, 3, 1))


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    """The card's route has no fallback: with no compiler the build of
    csrc/fused_stdc.cu raises."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library("fused_stdc")


def test_supported_takes_every_shape_the_tpu_kernels_take():
    for b, h, w, c in ((2, 16, 16, 64), (2, 32, 32, 32), (8, 128, 256, 64),
                       (8, 16, 32, 1024), (1, 8, 6, 3)):
        for stride in (1, 2):
            if jax_fs.supported((b, h, w, c), stride):
                assert fs.supported((b, c, h, w), stride)
    assert fs.supported((1, 3, 7, 9), 2) and fs.supported((1, 3, 1, 1), 1)
    assert not fs.supported((1, 3, 8, 8), 3)
    assert not fs.supported((1, 0, 8, 8), 1)


def _chip_smoke_table():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.STDC813_BOTTLENECKS


#: the six STDC813 bottlenecks at batch 8 and 1024x512 that chip_smoke.py
#: checks and times: stride, (Cin, H, W), (h1, h2, h3, h4)
STDC813_BOTTLENECKS = _chip_smoke_table()


def test_table_matches_the_model():
    """The shapes chip_smoke.py checks are the model's own: features[2:8]
    of STDCNet813 on a 1024x512 image (features[1] leaves 64 x 128 x 256)."""
    from dasemanticsegmentationaml_tpu_torch.models.stdcnet import STDCNet813

    net = STDCNet813()
    shape = (64, 128, 256)
    for (stride, chw, chans), block in zip(STDC813_BOTTLENECKS,
                                           net.features[2:8]):
        assert chw == shape and block.stride == stride
        assert block.conv_list[0].conv.in_channels == chw[0]
        assert tuple(m.conv.out_channels for m in block.conv_list) == chans
        shape = (sum(chans), -(-chw[1] // stride), -(-chw[2] // stride))


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("stride,chw,chans", STDC813_BOTTLENECKS)
def test_plan_fits_shared_memory(stride, chw, chans, elem):
    """Each bottleneck gets a tile within 227 KB whose buffers hold what
    the kernel puts in them."""
    c, h, w = chw
    out_hw = (-(-h // stride), -(-w // stride))
    p = fs.plan(stride, elem, c, chans, 8, out_hw)
    assert p is not None and p.smem <= fs.SMEM_LIMIT and p.off_b % 16 == 0
    h1, h2, h3, _ = chans
    r = lambda k: (p.th + 2 * k) * (p.tw + 2 * k)  # noqa: E731
    assert p.off_b >= h1 * r(3) * elem >= h3 * r(1) * elem
    second = p.smem - p.off_b
    assert second >= h2 * r(2) * elem
    if stride == 2:
        assert p.chunk in (8, 16, 32)
        assert second >= p.chunk * (2 * p.th + 13) * (2 * p.tw + 13) * elem
