"""The port's serving artifacts (``utils/export.py``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_export.py`` on the port: a symbolic-batch
``torch.export`` artifact round-trips through ``torch.export.save`` /
``load`` and equals the live serving module at batch 1 and 3; its
normalisation is JAX ``make_serving_fn``'s; the fp32 and the int8
``all`` artifacts label the same seeded uint8 frames as JAX's
``export_inference(...).call`` on at least 0.999 of the pixels (the
port's artifact runs the upsample+argmax kernel's plain version, JAX's
the full forward and ``argmax``: fp32 rounding may flip a tie); a bundle
is told from a ``.pt2`` (itself a zip) by its index. The weights are the
same numpy-seeded JAX variables, carried across by
``variables_to_torch_state`` as a user's checkpoint; each JAX artifact
is built once for the module.
"""

import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasemanticsegmentationaml_tpu.models.bisenet import BiSeNet as JaxBiSeNet
from dasemanticsegmentationaml_tpu.ops import quantize as jq
from dasemanticsegmentationaml_tpu.utils import export as jax_export
from dasemanticsegmentationaml_tpu.utils import torch_io
from dasemanticsegmentationaml_tpu_torch.models import BiSeNet
from dasemanticsegmentationaml_tpu_torch.ops import quantize as q
from dasemanticsegmentationaml_tpu_torch.utils import export as ex
from dasemanticsegmentationaml_tpu_torch.utils.weights import (
    load_reference_state)

from test_torch_models import nchw, seeded_variables

H, W = 64, 128
#: labels of the port's artifact equal to JAX's on at least this share
AGREE = 0.999


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def pair():
    """The JAX BiSeNet (fp32) with numpy-seeded variables, the same
    weights in the port's BiSeNet, and two NHWC calibration batches."""
    jax_model = JaxBiSeNet(n_classes=19, dtype=jnp.float32)
    variables = seeded_variables(
        lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
                               method=JaxBiSeNet.full_init), seed=0)
    model = BiSeNet(19).eval()
    load_reference_state(model, torch_io.variables_to_torch_state(variables),
                         strict=True)
    variables = {"params": variables["params"],
                 "batch_stats": variables["batch_stats"]}
    rng = np.random.default_rng(2)
    calib = [rng.standard_normal((2, H, W, 3)).astype(np.float32)
             for _ in range(2)]
    return jax_model, variables, model, calib


def _frames(seed, b):
    return np.random.default_rng(seed).integers(0, 256, (b, H, W, 3),
                                                dtype=np.uint8)


def _run(module, frames):
    with torch.inference_mode():
        return module(torch.from_numpy(frames)).numpy()


def test_port_export_roundtrip_symbolic_batch(pair, tmp_path):
    """tests/test_export.py:32: one artifact serves batch 1 and 3, equal
    to the live serving module, uint8 in and int32 out."""
    _, _, model, _ = pair
    path = str(tmp_path / "m.pt2")
    exported = ex.export_inference(model, H, W, path=path)
    assert exported.meta["batch"] is None and exported.meta["device"] == "cpu"
    assert ex.read_meta(path) == exported.meta
    serve = ex.load_exported(path)
    live = ex.make_serving_fn(model)
    for b in (1, 3):
        frames = _frames(b, b)
        got = _run(serve, frames)
        assert got.shape == (b, H, W) and got.dtype == np.int32
        np.testing.assert_array_equal(got, _run(live, frames))


class _CapturingModel:
    """A stand-in for the JAX model that keeps the input
    ``make_serving_fn`` hands it (its normalisation) and returns zeros."""

    dtype = jnp.float32

    def __init__(self):
        self.seen = []

    def apply(self, variables, x, train=False):
        self.seen.append(x)
        out = jnp.zeros(x.shape[:3] + (19,), jnp.float32)
        return out, out, out


def test_port_preprocess_matches_jax_normalisation():
    """The artifact's uint8 -> normalised NCHW against JAX
    ``make_serving_fn``'s: exact against its ops run one by one, within
    the 1e-6 (2 ulp) that test_prepare_batch_matches_jax allows against
    the jitted function."""
    frames = _frames(5, 2)
    stub = _CapturingModel()
    jax_export.make_serving_fn(stub, None)(jnp.asarray(frames))
    eager = np.asarray(stub.seen[-1])

    def normalise(images):
        jax_export.make_serving_fn(stub, None)(images)
        return stub.seen[-1]

    jitted = np.asarray(jax.jit(normalise)(jnp.asarray(frames)))
    serving = ex.make_serving_fn(BiSeNet(19))
    got = serving.normalise(torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == (2, 3, H, W)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_fp32(pair):
    jax_model, variables, _, _ = pair
    return jax_export.export_inference(jax_model, variables, H, W)


@pytest.fixture(scope="module")
def jax_int8(pair):
    jax_model, variables, _, calib = pair
    qm, qv = jq.quantize_model(jax_model, variables,
                               [jnp.asarray(c) for c in calib])
    return jax_export.export_inference(qm, qv, H, W)


def test_port_artifact_matches_jax_artifact(pair, jax_fp32, tmp_path):
    """The port's fp32 artifact against JAX ``export_inference(...).call``
    on the same seeded uint8 frames."""
    _, _, model, _ = pair
    path = str(tmp_path / "m.pt2")
    ex.export_inference(model, H, W, path=path)
    frames = _frames(7, 3)
    got = _run(ex.load_exported(path), frames)
    want = np.asarray(jax_fp32.call(jnp.asarray(frames)))
    assert np.mean(got == want) >= AGREE


def test_port_int8_artifact_matches_jax_int8_artifact(pair, jax_int8,
                                                      tmp_path):
    """The int8 ``all`` model (35 blocks, the same calibration batches) as
    an artifact against JAX's quantized export; the artifact holds the
    ``dseg::int8_conv`` op."""
    _, _, model, calib = pair
    qmodel, quant = q.quantize_model(model, [nchw(c) for c in calib])
    assert len(quant) == 35
    path = str(tmp_path / "q.pt2")
    exported = ex.export_inference(qmodel, H, W, path=path)
    assert exported.meta["ops"] == ["int8_conv", "upsample_argmax"]
    frames = _frames(8, 3)
    got = _run(ex.load_exported(path), frames)
    want = np.asarray(jax_int8.call(jnp.asarray(frames)))
    assert np.mean(got == want) >= AGREE


@pytest.mark.parametrize("preprocess,fused", [(True, False), (False, True)])
def test_port_export_variants_match_live(pair, tmp_path, preprocess, fused):
    """use_fused_kernel=False exports the full forward then argmax (JAX
    :70-71), with no op; preprocess=False takes normalised NCHW in the
    compute dtype. Each round-trips equal to its live module."""
    _, _, model, _ = pair
    path = str(tmp_path / "v.pt2")
    exported = ex.export_inference(model, H, W, preprocess=preprocess,
                                   use_fused_kernel=fused, path=path)
    assert exported.meta["ops"] == (["upsample_argmax"] if fused else [])
    live = ex.make_serving_fn(model, preprocess=preprocess,
                              use_fused_kernel=fused)
    frames = torch.from_numpy(_frames(9, 2))
    x = frames if preprocess else live.normalise(frames)
    with torch.inference_mode():
        np.testing.assert_array_equal(ex.load_exported(path)(x).numpy(),
                                      live(x).numpy())


def test_port_export_bf16_records_its_numerics(pair, tmp_path):
    """A bf16 artifact keeps autocast (on the export's device type) and
    equals the live bf16 module; its metadata names the dtype and the
    TF32 settings of the export."""
    _, _, model, _ = pair
    path = str(tmp_path / "bf16.pt2")
    exported = ex.export_inference(model, H, W, amp_dtype=torch.bfloat16,
                                   path=path)
    meta = ex.read_meta(path)
    assert meta == exported.meta and meta["dtype"] == "bfloat16"
    assert meta["cudnn_allow_tf32"] == torch.backends.cudnn.allow_tf32
    frames = _frames(10, 2)
    np.testing.assert_array_equal(
        _run(ex.load_exported(path), frames),
        _run(ex.make_serving_fn(model, amp_dtype=torch.bfloat16), frames))


def test_port_bundle_roundtrip(pair, tmp_path):
    """``is_bundle`` is false on a plain ``.pt2`` (a zip too) and true on a
    bundle; each program of a bundle serves its own batch, equal to the
    live module; the index lists the batches."""
    _, _, model, _ = pair
    plain, bundle = str(tmp_path / "m.pt2"), str(tmp_path / "b.zip")
    ex.export_inference(model, H, W, path=plain)
    ex.export_inference_bundle(model, H, W, [4, 1, 4], path=bundle)
    assert zipfile.is_zipfile(plain) and not ex.is_bundle(plain)
    assert ex.is_bundle(bundle)
    assert ex.read_meta(bundle)["batches"] == [1, 4]
    programs = ex.read_exported_bundle(bundle)
    assert sorted(programs) == [1, 4]
    live = ex.make_serving_fn(model)
    for b, exported in programs.items():
        assert exported.meta["batch"] == b
        frames = _frames(11, b)
        np.testing.assert_array_equal(_run(exported.program.module(), frames),
                                      _run(live, frames))
    with pytest.raises(ValueError):
        ex.export_inference_bundle(model, H, W, [])


def test_port_read_meta_refuses_other_archives(tmp_path):
    """A zip without the artifact's metadata is no artifact."""
    path = str(tmp_path / "other.zip")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("x.txt", "x")
    assert not ex.is_bundle(path)
    with pytest.raises(ValueError, match="not an artifact"):
        ex.read_meta(path)


def test_port_export_numerics_restores_tf32():
    """``export_numerics`` sets the recorded TF32 flags and restores the
    process's own on exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    meta = {"cudnn_allow_tf32": not saved[0], "matmul_allow_tf32": True}
    with ex.export_numerics(meta):
        assert torch.backends.cudnn.allow_tf32 == (not saved[0])
        assert torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == saved


def test_port_meta_is_json_in_the_archive(pair, tmp_path):
    """The metadata sits in the ``.pt2`` as ``extra/dseg_meta.json``, and a
    bundle's index holds the programs' shared metadata."""
    _, _, model, _ = pair
    path = str(tmp_path / "m.pt2")
    ex.export_inference(model, H, W, batch=2, path=path)
    with zipfile.ZipFile(path) as zf:
        name = next(n for n in zf.namelist()
                    if n.endswith(f"extra/{ex.META_NAME}"))
        meta = json.loads(zf.read(name))
    assert meta["batch"] == 2 and meta["height"] == H and meta["width"] == W
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr(ex.BUNDLE_META, json.dumps({**meta, "batches": [2]}))
    buf.seek(0)
    assert ex.read_meta(buf)["batches"] == [2]
