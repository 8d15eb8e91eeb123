"""The int8 conv's row and column padding and the banded int8 forward of
the height-sharded mesh, on the CPU.

* ``int8_conv``'s plain version with a ``(pad_h, pad_w)`` pair against
  ``F.conv2d`` of the explicitly padded int8 values (the kernel's
  contract, ``csrc/int8_conv.cu``); ``plan`` and the prologue's plain
  version take the pair, and an ``int`` still means both.
* A band: the rows a band of output reads (its halo, zeros outside the
  image) convolved with ``pad_h = 0`` equal the whole conv's rows, bit
  for bit, for each kind of block BiSeNet-STDC813 quantizes (3×3 s1 and
  s2, 1×1, the im2col stem).
* An artifact saved when ``dseg::int8_conv`` took one ``int`` of padding
  (``tests/data/int8_conv_int_padding.pt2``: a module calling
  ``int8_conv(x, ..., stride=1, padding=1)`` on seeded int8 weights,
  exported by the port before the pair) still loads and computes what the
  plain version does.
* At world 2 (two gloo ranks, ``tests/torch_ranks.py::int8_bands``),
  every int8 block of BiSeNet-STDC813 quantized with the ``all`` filter,
  on its band of its own input in the whole int8 forward, equals that
  block's whole output rows bit for bit, in fp32 and bf16 (the int8 sums
  are exact and the epilogue elementwise; JAX partitions
  ``ops/quantize.py::int8_conv_epilogue`` :108 by height the same way).
* ``SpatialMesh.convert`` of an int8 model keeps every int8 block's
  ``conv``, gives the block the mesh and keeps the state-dict names; a
  block the filter left in fp has its conv banded as before.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from torch_ranks import int8_bands, run_ranks

from dasemanticsegmentationaml_tpu_torch.models import BiSeNet
from dasemanticsegmentationaml_tpu_torch.ops import quantize as q
from dasemanticsegmentationaml_tpu_torch.ops.cuda import int8_conv as ic
from dasemanticsegmentationaml_tpu_torch.parallel.spatial import (
    BandedConv2d, SpatialMesh, keep_band, window_needs)

OLD_ARTIFACT = os.path.join(os.path.dirname(__file__), "data",
                            "int8_conv_int_padding.pt2")

#: (cin, cout, kernel, stride, padding) of each kind of int8 block
BLOCKS = {"3x3_s1": (16, 24, 3, 1, 1), "3x3_s2": (16, 24, 3, 2, 1),
          "1x1": (32, 16, 1, 1, 0), "stem_im2col": (3, 8, 3, 2, 1)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _operands(cin, cout, k, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k))
                         ).to(torch.int8)
    out_mul = torch.from_numpy(rng.uniform(1e-4, 1e-3, cout)).float()
    bias = torch.from_numpy(rng.standard_normal(cout)).float()
    return w, ic.pack_weights(w), out_mul, bias, torch.tensor(20.0)


def _input(cin, h=16, w=12, seed=1, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((2, cin, h, w))).to(dtype)


@pytest.mark.parametrize("pad", [(1, 1), (0, 1), (1, 0), (0, 0), (2, 1)])
@pytest.mark.parametrize("block", ["3x3_s1", "3x3_s2", "stem_im2col"])
def test_int8_pad_pair_is_conv2d_of_the_padded_int8_values(block, pad):
    cin, cout, k, s, _ = BLOCKS[block]
    w, packed, out_mul, bias, inv = _operands(cin, cout, k)
    x = _input(cin)
    got = ic.int8_conv(x, w, packed, out_mul, bias, inv, s, pad)
    xq = ic.quantize_activation(x, inv).double()
    padded = F.pad(xq, (pad[1], pad[1], pad[0], pad[0]))
    acc = F.conv2d(padded, w.double(), stride=s).to(torch.int32)
    want = torch.relu(acc.float() * out_mul.view(1, -1, 1, 1)
                      + bias.view(1, -1, 1, 1))
    assert torch.equal(got, want)
    p = ic.plan(2, cin, 16, 12, cout, k, s, pad, 132)
    assert (p.out_h, p.out_w) == tuple(got.shape[2:])
    if pad[0] == pad[1]:
        assert p == ic.plan(2, cin, 16, 12, cout, k, s, pad[0], 132)
        assert torch.equal(got, ic.int8_conv(x, w, packed, out_mul, bias,
                                             inv, s, pad[0]))


@pytest.mark.parametrize("pad", [(0, 1), (1, 0)])
def test_int8_prologue_reference_takes_the_pair(pad):
    """The im2col rows of the stem with a pair: each tap of a row is the
    padded int8 input's value there."""
    x = _input(3)
    inv = torch.tensor(20.0)
    rows = ic.quantize_input_reference(x, inv, 3, 2, pad)
    xq = F.pad(ic.quantize_activation(x, inv), (pad[1], pad[1], pad[0],
                                                 pad[0]))
    oh, ow = rows.shape[1:3]
    for kh in range(3):
        for kw in range(3):
            tap = xq[:, :, kh:kh + 2 * (oh - 1) + 1:2,
                     kw:kw + 2 * (ow - 1) + 1:2].permute(0, 2, 3, 1)
            j = (kh * 3 + kw) * 3
            assert torch.equal(rows[..., j:j + 3], tap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_int8_band_window_equals_the_whole_rows(block, dtype):
    """Each of two bands of output rows, from the rows it reads (zeros
    outside the image) with ``pad_h = 0``, against the whole conv's."""
    cin, cout, k, s, p = BLOCKS[block]
    w, packed, out_mul, bias, inv = _operands(cin, cout, k, seed=3)
    x = _input(cin, seed=4, dtype=dtype)
    whole = ic.int8_conv(x, w, packed, out_mul, bias, inv, s, p)
    n_out = whole.shape[2]
    for lo_o, hi_o in ((0, n_out // 2), (n_out // 2, n_out)):
        lo, hi = lo_o * s - p, (hi_o - 1) * s - p + k
        padded = F.pad(x, (0, 0, p, p))
        window = padded[:, :, lo + p:hi + p].contiguous()
        band = ic.int8_conv(window, w, packed, out_mul, bias, inv, s,
                            (0, p))
        assert torch.equal(band, whole[:, :, lo_o:hi_o]), (lo_o, hi_o)


def test_int8_artifact_saved_with_an_int_padding_still_serves():
    program = torch.export.load(OLD_ARTIFACT)
    nodes = [n for n in program.graph.nodes
             if n.op == "call_function" and "int8_conv" in str(n.target)]
    assert len(nodes) == 1 and nodes[0].args[7] == 1   # one int
    buffers = program.state_dict
    x = _input(4, h=6, w=5, seed=5)
    want = ic.int8_conv_reference(x, buffers["w"], buffers["m"],
                                  buffers["b"], buffers["s"], 1, (1, 1))
    with torch.inference_mode():
        assert torch.equal(program.module()(x), want)


# ------------------------------------------------- the banded int8 model

@pytest.fixture(scope="module")
def int8_model():
    """BiSeNet-STDC813 (seeded) quantized with ``all`` on a 128x64 batch,
    and each int8 block's input and output in the whole int8 forward."""
    torch.manual_seed(0)
    model = BiSeNet(19).eval()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 3, 128, 64))).float()
    qmodel, _ = q.quantize_model(model, [x])
    seen = {}

    def keep(name):
        def hook(module, args, out):
            seen.setdefault(name, (args[0].clone(), out.clone()))
        return hook

    hooks = [block.register_forward_hook(keep(name))
             for name, block in q.quant_blocks(qmodel)]
    with torch.inference_mode():
        qmodel(x)
    for h in hooks:
        h.remove()
    return qmodel, seen


def test_int8_blocks_in_two_bands_equal_the_whole_blocks(int8_model,
                                                        tmp_path):
    model, seen = int8_model
    assert len(seen) == 35
    shapes = {(b.conv.in_channels < ic.PIECE, b.conv.kernel_size[0],
               b.conv.stride[0]) for _, b in q.quant_blocks(model)}
    assert {(True, 3, 2), (False, 3, 1), (False, 3, 2),
            (False, 1, 1)} <= shapes
    inputs = {name: x for name, (x, _) in seen.items()}
    # the first six blocks (the stem among them) in bf16 too
    inputs.update({f"{name}#bf16": x.bfloat16()
                   for name, x in list(inputs.items())[:6]})
    blocks = dict(model.named_modules())
    with torch.inference_mode():
        whole = {name: blocks[name.split("#")[0]](x)
                 for name, x in inputs.items() if "#" in name}
    whole.update({name: y for name, (_, y) in seen.items()})
    got = run_ranks(int8_bands, tmp_path, world=2, model=model,
                    inputs=inputs)
    for rank, bands in enumerate(got):
        for name, y in bands.items():
            want = whole[name]
            if want.shape[2] > 1:
                want = keep_band(want, rank, 2)
            assert torch.equal(y, want), name


def test_convert_keeps_the_int8_blocks_conv_and_state_names():
    torch.manual_seed(0)
    model = BiSeNet(19).eval()
    x = torch.zeros((1, 3, 128, 64))
    qmodel, quant = q.quantize_model(model, [x], filter_fn=q.PRESET_FILTERS[
        "head_ch"])
    names = list(qmodel.state_dict())
    mesh = SpatialMesh.for_export(2)
    mesh.convert(qmodel)
    assert list(qmodel.state_dict()) == names
    enabled = disabled = 0
    for name, block in q.quant_blocks(qmodel):
        if block.quant is None:     # the unused conv_last: no record
            assert name == "cp.backbone.conv_last"
        elif "disabled" in block.quant:
            disabled += 1
            assert block.mesh is None
            if block.conv.kernel_size[0] == 3:
                assert isinstance(block.conv, BandedConv2d)
        else:
            enabled += 1
            assert block.mesh is mesh and type(block.conv) is nn.Conv2d
    assert enabled == 3 and disabled == 32


def test_band_window_needs_match_the_kernel_rows():
    """``window_needs`` of an even band of a 3x3 s2 p1 conv is the rows
    the band test above reads."""
    from dasemanticsegmentationaml_tpu_torch.parallel.spatial import (
        Rows, layer_rows)

    rows = Rows.even(16, 2)
    out_rows = layer_rows(rows, 8, 3, 2, 1)
    assert out_rows.bounds == (0, 4, 8)
    assert window_needs(out_rows, 3, 2, 1) == ((-1, 8), (7, 16))
