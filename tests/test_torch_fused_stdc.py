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
    """Each bottleneck gets a plan within 227 KB whose buffers hold what
    the kernel puts in them. fp32 (``plan``): the CUDA-core body's two
    halo buffers. bf16 (``tc_plan``): the weight ring, the staged input of
    every stage and the stride-2 front's x1 region, each at a row pitch
    that is a whole, odd number of 16-byte units (ldmatrix's 8 rows on 8
    bank groups), and as many blocks an SM as shared memory holds."""
    c, h, w = chw
    out_hw = (-(-h // stride), -(-w // stride))
    if elem == 4:
        p = fs.plan(stride, elem, c, chans, 8, out_hw, 132)
        assert p is not None and p.smem <= fs.SMEM_LIMIT and p.off_b % 16 == 0
        h1, h2, h3, _ = chans
        r = lambda k: (p.th + 2 * k) * (p.tw + 2 * k)  # noqa: E731
        assert p.off_b >= h1 * r(3) * elem >= h3 * r(1) * elem
        second = p.smem - p.off_b
        assert second >= h2 * r(2) * elem
        if stride == 2:
            assert p.chunk in (8, 16, 32)
            assert second >= p.chunk * (2 * p.th + 13) * (2 * p.tw + 13) * elem
        return
    p = fs.tc_plan(stride, c, chans, 8, (h, w), 132)
    assert p.smem <= fs.SMEM_LIMIT
    assert p.off_act == fs.TC_BAR_BYTES + fs.TC_SLOTS * fs.TC_SLOT_BYTES
    assert p.off_act % 128 == 0 and p.off_act + p.act_bytes <= p.smem
    assert p.grid == 132 * p.blocks_per_sm
    assert 1 <= p.blocks_per_sm <= fs.TC_MAX_BLOCKS_PER_SM
    assert p.blocks_per_sm * (p.smem + 1024) <= fs.SMEM_PER_SM
    cins = (c,) + tuple(chans[:3])
    for k, st in enumerate(p.stages):
        hw = (h, w) if k == 0 else out_hw
        assert (st.cin, st.cout) == (cins[k], chans[k])
        assert st.taps == (9 if k else 1) and st.th * st.tw == 32 * st.mt
        assert st.kc % 16 == 0 and st.nk * st.kc == st.pitch >= st.cin
        # a slice fits a ring slot, at a pitch odd in 16-byte units
        assert fs.TC_BN * st.row_bytes <= fs.TC_SLOT_BYTES
        assert st.row_bytes % 16 == 0 and (st.row_bytes // 16) % 2 == 1
        # each of its two buffers holds a chunk of staged input: pixel-
        # major with a one-pixel halo, or (the entry) channel-major
        assert 2 * st.buf_bytes <= p.act_bytes
        # then the epilogue's tile of 32 mt pixels x 64 + 8 channels
        assert st.th * st.tw * (fs.TC_BN + 8) * 2 == st.tile_bytes
        assert st.tile_bytes <= p.act_bytes
        assert st.buf_bytes % 128 == 0 and st.buf_bytes >= st.stage_bytes
        if k:
            assert st.stage_bytes == ((st.th + 2) * (st.tw + 2)
                                      * st.row_bytes)
        else:
            ldm = st.th * st.tw + 8
            assert (st.stage_bytes == min(2, st.nk) * st.kc * ldm * 2
                    and (ldm // 8) % 2 == 1)
        tiles = (st.tiles_y * st.th, st.tiles_x * st.tw)
        assert hw[0] <= tiles[0] < hw[0] + st.th
        assert hw[1] <= tiles[1] < hw[1] + st.tw
    if stride == 2:
        # avd_pool: the tile's x1 pixels and its avd and pool tiles, 64 + 8
        # bf16 each
        npx = (2 * p.dw_th + 1) * (2 * p.dw_tw + 1)
        assert p.dw_bytes == ((npx + 2 * p.dw_th * p.dw_tw)
                              * (fs.TC_BN + 8) * 2)
        assert p.off_act + p.dw_bytes <= p.smem
    else:
        assert p.dw_th == p.dw_tw == p.dw_bytes == 0


@pytest.mark.parametrize("sms", [66, 114, 132])
def test_plans_take_the_sm_count(sms):
    """The grid is the card's SM count times the blocks an SM holds, and
    neither plan reads a fixed count: features[7] (stride 1) and
    features[6] (stride 2) at batch 8."""
    for stride, (c, h, w), chans in STDC813_BOTTLENECKS[4:]:
        p = fs.tc_plan(stride, c, chans, 8, (h, w), sms)
        assert p.grid == sms * p.blocks_per_sm
        assert fs.tc_plan(stride, c, chans, 8, (h, w), sms, 1).grid == sms
        out_hw = (-(-h // stride), -(-w // stride))
        assert fs.plan(stride, 4, c, chans, 8, out_hw, sms) is not None


def _unpack_mma(packed, cout, cin, k):
    """The inverse of ``pack_mma``, in plain torch: (nblk, nk, taps, 64,
    kc + 8) -> OIHW (cout, cin, k, k), after checking that every padded
    place is zero."""
    nblk, nk, taps, bn, row = packed.shape
    kc = row - 8
    assert bn == fs.TC_BN and taps == k * k
    assert not packed[..., kc:].any()
    full = packed[..., :kc].permute(0, 3, 1, 4, 2).reshape(
        nblk * bn, nk * kc, taps)
    assert not full[cout:].any() and not full[:, cin:].any()
    return full[:cout, :cin].reshape(cout, cin, k, k)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("in_c,out_c", [
    (24, 32),     # (16, 8, 4, 4): every conv below the MMA's 64 x 16
    (40, 64),     # (32, 16, 8, 8); Cin 40 pads to 48
    (64, 256),    # features[2]'s channels: whole slices
    (200, 160),   # (80, 40, 20, 20): a ragged last block and chunk
])
def test_mma_packing_unpacks_to_the_folded_weights(stride, in_c, out_c):
    """The bf16 body's packed weights hold fold_cat_params' OIHW weights
    bit for bit, zeros everywhere else, and its biases padded to whole
    blocks of 64; the avd conv stays fp32 (h1, 9)."""
    _, _, block = _pair(stride, in_c, out_c, 8, 8)
    fp = fs.fold_cat_params(block, torch.bfloat16)
    convs = (fp.w1, fp.k2, fp.k3, fp.k4)
    biases = (fp.b1, fp.b2, fp.b3, fp.b4)
    assert len(fp.packed) == (10 if stride == 2 else 8)
    for n, (k, b) in enumerate(zip(convs, biases)):
        packed, bias = fp.packed[2 * n], fp.packed[2 * n + 1]
        cout, cin, kh, _ = k.shape
        assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
        assert packed.shape[4] - 8 == fs.mma_chunk(cin)
        assert torch.equal(_unpack_mma(packed, cout, cin, kh), k)
        assert bias.dtype == torch.float32
        assert bias.shape[0] == packed.shape[0] * fs.TC_BN
        assert torch.equal(bias[:cout], b) and not bias[cout:].any()
    if stride == 2:
        h1 = fp.channels[0]
        assert torch.equal(fp.packed[8], fp.avd_k.float().reshape(h1, 9))
        assert torch.equal(fp.packed[9], fp.avd_b)
