"""The port's int8 PTQ (``ops/quantize.py``) against the JAX package's.

Mirrors ``tests/test_quantize.py`` on the port's modules: the weight
quantizer, int8 against fp32 on one ConvX, inference only, a missing entry
raises, calibration maxes over batches, the p999 clip (robust to an
outlier, back to absmax on a sparse input), the presets partition
BiSeNet's blocks as JAX's do, "off" is param-neutral, and the full model
with its 35 blocks. The quant collection is held against JAX's, built
from the same weights (carried by ``variables_to_torch_state``, as a
user's checkpoint) and the same calibration batches: ``w_int8`` equal on
at least 99.99% of the elements and off by one elsewhere (a product on a
rounding boundary may round the other way), ``out_mul`` and
``in_inv_scale`` within 1e-6 relative, ``bias`` within 1e-6 of its
summands (it cancels, and XLA computes BN's inverse by rsqrt). JAX's
calibration is compiled once for the module. Last, the ``--domain_shift
--quantize_int8`` CLI against the JAX CLI (same ``.pth``, 64x128 tree,
fp32), within the eval CLI's 1e-3 (PERF.md §2), and the port's CLI for
every filter and clip.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from dasemanticsegmentationaml_tpu import cli as jax_cli
from dasemanticsegmentationaml_tpu.models.bisenet import BiSeNet as JaxBiSeNet
from dasemanticsegmentationaml_tpu.ops import quantize as jq
from dasemanticsegmentationaml_tpu.utils import torch_io
from dasemanticsegmentationaml_tpu_torch import cli
from dasemanticsegmentationaml_tpu_torch.models import BiSeNet
from dasemanticsegmentationaml_tpu_torch.models.stdcnet import ConvX
from dasemanticsegmentationaml_tpu_torch.ops import quantize as q
from dasemanticsegmentationaml_tpu_torch.utils.config import QUANTIZE_FILTERS
from dasemanticsegmentationaml_tpu_torch.utils.weights import (
    load_reference_state)

from test_torch_eval import H, W, _mk_cityscapes, _seeded_pth
from test_torch_models import seeded_variables

#: the JAX tests' size: 1x3x32x64 images, two calibration batches of 2
CH, CW = 32, 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def port_name(path):
    """A JAX module path -> the port's module name (``features_3`` ->
    ``features.3``, ``conv_list_1`` -> ``conv_list.1``)."""
    return ".".join(re.sub(r"_(\d+)$", r".\1", seg) for seg in path)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(
        0, 3, 1, 2)))


@pytest.fixture(scope="module")
def convx():
    """A port ConvX(8 -> 16, 3x3, stride 2) with seeded weights and BN
    statistics, and an input (tests/test_quantize.py:40)."""
    torch.manual_seed(1)
    m = ConvX(8, 16, kernel=3, stride=2).eval()
    rng = np.random.default_rng(1)
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(
            rng.standard_normal((16, 8, 3, 3)).astype(np.float32) * 0.2))
        m.bn.weight.copy_(torch.from_numpy(
            1 + 0.1 * rng.standard_normal(16).astype(np.float32)))
        m.bn.bias.copy_(torch.from_numpy(
            0.1 * rng.standard_normal(16).astype(np.float32)))
        m.bn.running_mean.copy_(torch.from_numpy(
            0.1 * rng.standard_normal(16).astype(np.float32)))
        m.bn.running_var.copy_(torch.from_numpy(
            0.5 + rng.random(16).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((2, 8, 16, 16)).astype(
        np.float32))
    return m, x


def _fp(m, x):
    with torch.inference_mode():
        return m(x)


def _int8(m, batches, x, **kw):
    qm, quant = q.quantize_model(m, batches, **kw)
    with torch.inference_mode():
        return qm(x), qm, quant


def test_port_weight_quantizer_per_channel():
    """tests/test_quantize.py:29, and equal to JAX's on the same weights."""
    rng = np.random.default_rng(0)
    k = (rng.standard_normal((3, 3, 8, 16))
         * rng.uniform(0.1, 10.0, (16,))).astype(np.float32)
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    qw, scale = q.quantize_weights_per_channel(w)
    assert qw.dtype == torch.int8 and scale.shape == (16,)
    assert int(qw.abs().max()) <= 127
    err = (qw.float() * scale.view(-1, 1, 1, 1) - w).abs().amax(dim=(1, 2, 3))
    assert bool((err <= scale * 0.5 + 1e-7).all())
    want_q, want_scale = jq.quantize_weights_per_channel(jnp.asarray(k))
    np.testing.assert_array_equal(qw.numpy(),
                                  np.asarray(want_q).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want_scale))


def test_port_convx_int8_matches_fp32(convx):
    m, x = convx
    ref = _fp(m, x)
    out, _, quant = _int8(m, [x], x)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    rel = float((out - ref).abs().max() / ref.abs().max())
    assert rel < 0.05
    assert set(quant) == {""}
    assert set(quant[""]) == {"w_int8", "w_packed", "out_mul", "bias",
                              "in_inv_scale"}


def test_port_int8_mode_is_inference_only(convx):
    m, x = convx
    qm, _ = q.quantize_model(m, [x])
    qm.train()
    with pytest.raises(ValueError, match="inference-only"):
        qm(x)


def test_port_int8_without_a_quant_entry_raises(convx):
    import copy

    m, x = convx
    qm = q.set_quant_mode(copy.deepcopy(m), "int8")
    with pytest.raises(ValueError, match="quant"):
        _fp(qm, x)


def test_port_calibration_takes_the_max_over_batches(convx):
    m, x = convx
    small, big = x * 0.1, x * 3.0
    calib_b = q.collect_calibration(m, [small, big])
    calib_s = q.collect_calibration(m, [small])
    assert float(calib_b[""]["in_absmax"]) == pytest.approx(
        float(big.abs().max()))
    assert float(calib_s[""]["in_absmax"]) < float(calib_b[""]["in_absmax"])
    quant = q.build_quant_collection(m, calib_b)
    assert float(quant[""]["in_inv_scale"]) == pytest.approx(
        127.0 / float(big.abs().max()), rel=1e-5)
    assert m.quant_mode == "off" and m.calib is None


def test_port_percentile_clip_is_outlier_robust(convx):
    """tests/test_quantize.py:161."""
    m, x = convx
    spiked = x.clone()
    spiked[0, 0, 0, 0] = 1000.0
    ref = _fp(m, x)

    def err_of(clip):
        out, _, _ = _int8(m, [spiked], x, clip=clip)
        return float((out - ref).norm() / ref.norm())

    assert err_of("p999") < 0.05
    assert err_of("absmax") > 0.5
    calib = q.collect_calibration(m, [spiked])
    assert float(calib[""]["in_absmax"]) == pytest.approx(1000.0)
    assert float(calib[""]["in_p999"]) < 50.0
    with pytest.raises(ValueError, match="clip"):
        q.quantize_model(m, [spiked], clip="p90")


def test_port_percentile_clip_sparse_input_falls_back(convx):
    """tests/test_quantize.py:193."""
    m, x = convx
    sparse = torch.zeros_like(x)
    sparse[0, 0, :2, :2] = 5.0
    ref = _fp(m, sparse)
    out, _, quant = _int8(m, [sparse], sparse, clip="p999")
    assert float(quant[""]["in_inv_scale"]) == pytest.approx(127.0 / 5.0,
                                                            rel=1e-5)
    assert float((out - ref).norm() / ref.norm()) < 0.1


@pytest.fixture(scope="module")
def bisenet_pair():
    """JAX BiSeNet variables from numpy (tests/test_torch_models.py's
    seeding), the same weights in the port's BiSeNet, two NHWC
    calibration batches, and JAX's calibration tree (compiled once)."""
    jax_model = JaxBiSeNet(n_classes=19)
    variables = seeded_variables(
        lambda: jax_model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, CH, CW, 3)),
                               method=JaxBiSeNet.full_init), seed=0)
    model = BiSeNet(19).eval()
    load_reference_state(model, torch_io.variables_to_torch_state(variables),
                         strict=True)
    rng = np.random.default_rng(2)
    batches = [rng.standard_normal((2, CH, CW, 3)).astype(np.float32)
               for _ in range(2)]
    variables = {"params": variables["params"],
                 "batch_stats": variables["batch_stats"]}
    calib = jq.collect_calibration(jax_model, variables,
                                   [jnp.asarray(b) for b in batches])
    return jax_model, variables, model, batches, calib


def _jax_selected(pair, filter_fn=None, clip="absmax"):
    _, variables, _, _, calib = pair
    flat = traverse_util.flatten_dict(jq.build_quant_collection(
        variables, calib, filter_fn=filter_fn, clip=clip))
    return flat


@pytest.mark.parametrize("clip", ["absmax", "p999"])
def test_port_quant_collection_matches_jax(bisenet_pair, clip):
    _, _, model, batches, _ = bisenet_pair
    want = _jax_selected(bisenet_pair, clip=clip)
    got = q.build_quant_collection(
        model, q.collect_calibration(model, [nchw(b) for b in batches]),
        clip=clip)
    paths = {p[:-1] for p in want}
    assert {port_name(p) for p in paths} == set(got) and len(got) == 35
    modules = dict(model.named_modules())
    n_diff = n_total = 0
    for p in paths:
        entry = got[port_name(p)]
        w_want = np.asarray(want[p + ("w_int8",)]).transpose(3, 2, 0, 1)
        d = np.abs(entry["w_int8"].numpy().astype(np.int32)
                   - w_want.astype(np.int32))
        assert d.max() <= 1, p
        n_diff += int((d > 0).sum())
        n_total += d.size
        for name in ("out_mul", "in_inv_scale"):
            np.testing.assert_allclose(entry[name].numpy(),
                                       np.asarray(want[p + (name,)]),
                                       rtol=1e-6, err_msg=f"{p} {name}")
        # the folded bias -mean * inv + beta cancels: XLA rewrites JAX's
        # scale / sqrt(var + eps) (norm.py:120) as a multiply by rsqrt,
        # one ulp of inv apart, so the bound is 1e-6 of the summands
        bn = modules[port_name(p)].bn
        inv = bn.weight / torch.sqrt(bn.running_var + 1e-5)
        terms = ((bn.running_mean * inv).abs() + bn.bias.abs()).detach()
        np.testing.assert_array_less(
            np.abs(entry["bias"].numpy() - np.asarray(want[p + ("bias",)])),
            1e-6 * terms.numpy() + 1e-30, err_msg=f"{p} bias")
    assert n_diff <= 1e-4 * n_total, (n_diff, n_total)


def test_port_presets_select_the_blocks_jax_selects(bisenet_pair):
    """Each preset of the port picks the blocks JAX's picks, and the
    partition tests/test_quantize.py:208 states holds on the port's
    names."""
    _, _, model, batches, _ = bisenet_pair
    calib = q.collect_calibration(model, [nchw(batches[0])])
    assert sorted(q.PRESET_FILTERS) == sorted(jq.PRESET_FILTERS) == \
        sorted(QUANTIZE_FILTERS)

    def chosen(quant):
        return {name for name, e in quant.items() if "w_int8" in e}

    sel = {}
    for name, fn in q.PRESET_FILTERS.items():
        sel[name] = chosen(q.build_quant_collection(model, calib,
                                                    filter_fn=fn))
        want = {port_name(p[:-1]) for p in _jax_selected(
            bisenet_pair, jq.PRESET_FILTERS[name]) if p[-1] == "w_int8"}
        assert sel[name] == want, name
    assert len(sel["all"]) == 35
    assert sel["head"] == {"conv_out.conv"}
    assert sel["backbone"] | sel["heads_cp"] == sel["all"]
    assert not sel["backbone"] & sel["heads_cp"]
    assert sel["head"] < sel["deep"] < sel["all"]
    assert not any(n.startswith(tuple(f"cp.backbone.features.{i}."
                                      for i in range(4)))
                   for n in sel["deep"])
    assert sel["head_ch"] - sel["head"] == {"cp.conv_head16", "cp.conv_head32"}
    assert all(n.startswith("ffm.") for n in sel["head_ffm"] - sel["head"])
    assert {".".join(n.split(".")[:4]) for n in sel["head_stem"]
            - sel["head"]} == {"cp.backbone.features.0",
                               "cp.backbone.features.1"}


def test_port_quant_mode_off_is_the_default_and_param_neutral(bisenet_pair):
    _, _, model, batches, _ = bisenet_pair
    assert all(b.quant_mode == "off" for _, b in q.quant_blocks(model))
    assert ConvX(3, 8).quant_mode == "off"
    before = {k: v.clone() for k, v in model.state_dict().items()}
    qmodel, _ = q.quantize_model(model, [nchw(batches[0])])
    after = model.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(after[k], before[k]) for k in before)
    assert list(qmodel.state_dict()) == list(before)
    assert all(b.quant_mode == "off" and b.calib is None and b.quant is None
               for _, b in q.quant_blocks(model))


def test_port_bisenet_int8_end_to_end(bisenet_pair):
    """tests/test_quantize.py:91: the 35 conv+BN+ReLU blocks quantize, the
    gates, classifiers and depthwise convs stay fp, and the int8 model's
    main head stays close to fp32: cosine > 0.995 as there. With these
    weights (He-normal, BN statistics drawn away from identity) JAX's own
    int8 model agrees with fp32 on 0.963 of the pixels, not the 0.97 its
    test sees with flax's initial weights, so the port is held to JAX's
    int8 model itself: the same predictions on 0.999 of the pixels, main
    head logits within 1e-4 of their largest."""
    jax_model, variables, model, batches, calib = bisenet_pair
    xs = [nchw(b) for b in batches]
    with torch.inference_mode():
        ref = model(xs[0])[0]
    qmodel, quant = q.quantize_model(model, xs)
    with torch.inference_mode():
        out = qmodel(xs[0])[0]
    cos = float((ref * out).sum() / (ref.norm() * out.norm()))
    agree = float((ref.argmax(1) == out.argmax(1)).float().mean())
    assert cos > 0.995
    assert agree > 0.95
    jq_vars = {**variables,
               "quant": jq.build_quant_collection(variables, calib)}
    want = np.asarray(jax.jit(lambda x: jax_model.clone(
        quant_mode="int8").apply(jq_vars, x, train=False)[0])(
            jnp.asarray(batches[0]))).transpose(0, 3, 1, 2)
    got = out.numpy()
    assert np.mean(got.argmax(1) == want.argmax(1)) >= 0.999
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert len(quant) == 35
    assert all(e["w_int8"].dtype == torch.int8 for e in quant.values())
    assert not any(n.endswith(("conv_atten", "conv_out")) for n in quant)


@pytest.mark.parametrize("qfilter", ["head_ch", "all"])
def test_port_int8_cli_matches_jax(tmp_path, qfilter):
    """``--domain_shift --quantize_int8 True`` of the two CLIs on one
    ``.pth`` and tree (64x128, fp32, two calibration batches of 2)."""
    root = str(tmp_path / "data")
    _mk_cityscapes(root, "val")
    pth = str(tmp_path / "best.pth")
    _seeded_pth(pth)
    argv = ["--root", root, "--domain_shift", "True", "--pretrain_path", pth,
            "--crop_height", str(H), "--crop_width", str(W),
            "--faithful_resize", "False", "--eval_batch_size", "2",
            "--num_workers", "1", "--dtype", "float32", "--tensorboard",
            "False", "--quantize_int8", "True", "--calib_batches", "2",
            "--quantize_filter", qfilter]
    want = jax_cli.main(argv + ["--num_devices", "1"])
    got = cli.main(argv + ["--cuda", "cpu"])
    assert abs(got["precision"] - want["precision"]) <= 1e-3
    assert abs(got["miou"] - want["miou"]) <= 1e-3
    assert 0.0 < got["miou"] <= 1.0


@pytest.mark.parametrize("clip", ["absmax", "p999"])
def test_port_int8_cli_runs_every_filter(tmp_path, clip):
    root = str(tmp_path / "data")
    _mk_cityscapes(root, "val", n=1, size=(CH, CW))
    argv = ["--root", root, "--domain_shift", "True", "--crop_height",
            str(CH), "--crop_width", str(CW), "--faithful_resize", "False",
            "--num_workers", "1", "--dtype", "float32", "--tensorboard",
            "False", "--quantize_int8", "True", "--calib_batches", "1",
            "--quantize_clip", clip, "--cuda", "cpu"]
    for qfilter in QUANTIZE_FILTERS:
        res = cli.main(argv + ["--quantize_filter", qfilter])
        assert 0.0 <= res["miou"] <= 1.0 and 0.0 <= res["precision"] <= 1.0
