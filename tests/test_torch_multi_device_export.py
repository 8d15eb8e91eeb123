"""The port's multi-device serving artifacts (``utils/export.py``) and
their N-rank runner (``serve.py``) on the CPU, two gloo ranks.

Mirrors JAX ``tests/test_export.py``'s ``test_export_sharded_pod_artifact``
(:162), ``test_serve_runner_pod_artifact`` (:221),
``test_export_spatial_latency_artifact`` (:257),
``test_serve_runner_spatial_artifact`` (:295) and
``test_export_sharded_quantized`` (:332). JAX's own tests hold its
sharded exports bit-equal to its one-device program, so the port is held
against JAX's one-device ``make_serving_fn`` on the same seeded weights:

* the batch-sharded artifact: each rank's labels bit-identical to the
  port's one-device artifact on the same sub-batch, at global batches 2
  and 6 from one symbolic artifact, and on at least 0.999 of the pixels
  equal to JAX's (the port upsamples in the kernel's plain version, JAX
  runs the full forward and ``argmax``); a concrete batch that 2 does not
  divide is refused in JAX's words; an int8 ``head_ch`` model exports and
  replays its live module exactly;
* the height-sharded artifact at 128×64 over two ranks: its programs hold
  the exchanges, the group sums and the windowed kernel as nodes; batch
  1 and 3 against JAX on at least 0.999 of the pixels;
  ``artifact_shard_dim`` is 1; a height of 96 is refused in JAX's words;
  an int8 ``all`` model's artifact equals the port's banded int8
  ``predict`` bit for bit;
* ``serve.main`` on both kinds over three PNGs with ``--device cpu,cpu``
  against the one-device artifact on the same sub-batches (sharded; bit
  for bit) and the live module (spatial; at least 0.999), and its stop on
  fewer devices than the artifact records.

Each model is exported once for the module; torch runs on one thread.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dasemanticsegmentationaml_tpu.utils import export as jax_export
from dasemanticsegmentationaml_tpu_torch import serve
from dasemanticsegmentationaml_tpu_torch.ops import quantize as q
from dasemanticsegmentationaml_tpu_torch.utils import export as ex

from test_torch_export import AGREE, H, W, one_thread, pair  # noqa: F401
from torch_ranks import run_ranks, spatial_predict, spatial_programs

#: the height-sharded artifact's frames: 128 rows keep every stride-2
#: stage of the stride-32 pyramid whole over 2 ranks (JAX's 128x64)
SH, SW = 128, 64


def _frames(seed, b, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                                dtype=np.uint8)


def _run(module, frames):
    with torch.inference_mode():
        return module(torch.from_numpy(frames)).numpy()


def _jax_labels(pair, frames):  # noqa: F811
    jax_model, variables, _, _ = pair
    fn = jax.jit(jax_export.make_serving_fn(jax_model, variables))
    return np.asarray(fn(jnp.asarray(frames)))


@pytest.fixture(scope="module")
def artifacts(pair, tmp_path_factory):  # noqa: F811
    """The fp32 model's one-device, batch-sharded (2 ranks) and spatial
    (2 ranks, 128x64) artifacts."""
    _, _, model, _ = pair
    root = tmp_path_factory.mktemp("artifacts")
    paths = {k: str(root / name) for k, name in (
        ("one", "one.pt2"), ("sharded", "sharded.pt2"),
        ("spatial", "spatial.zip"))}
    ex.export_inference(model, H, W, path=paths["one"])
    ex.export_inference_sharded(model, H, W, 2, path=paths["sharded"])
    ex.export_inference_spatial(model, SH, SW, 2, path=paths["spatial"])
    yield paths
    shutil.rmtree(str(root), ignore_errors=True)


def test_port_sharded_artifact_equals_one_device_on_rank_batches(
        pair, artifacts):  # noqa: F811
    meta = ex.read_meta(artifacts["sharded"])
    assert (meta["nr_devices"], meta["shard_dim"], meta["batch"]) == (
        2, 0, None)
    assert ex.artifact_shard_dim(meta) == 0
    assert meta["ops"] == ["upsample_argmax"]
    sharded = ex.load_exported(artifacts["sharded"])
    one = ex.load_exported(artifacts["one"])
    for seed, b in ((20, 2), (21, 6)):
        frames = _frames(seed, b)
        got = np.concatenate([_run(sharded, part)
                              for part in np.split(frames, 2)])
        want = np.concatenate([_run(one, part)
                               for part in np.split(frames, 2)])
        np.testing.assert_array_equal(got, want)
        assert np.mean(got == _jax_labels(pair, frames)) >= AGREE


def test_port_sharded_export_refuses_a_batch_two_does_not_divide(
        pair):  # noqa: F811
    _, _, model, _ = pair
    with pytest.raises(ValueError, match="batch 3 not divisible by the "
                                         "2-device mesh"):
        ex.export_inference_sharded(model, H, W, 2, batch=3)


def test_port_sharded_int8_head_ch_exports_and_replays(pair,
                                                       tmp_path):  # noqa: F811
    _, _, model, calib = pair
    batches = [torch.from_numpy(c).permute(0, 3, 1, 2).contiguous()
               for c in calib]
    qmodel, _ = q.quantize_model(model, batches,
                                 filter_fn=q.PRESET_FILTERS["head_ch"])
    path = str(tmp_path / "int8.pt2")
    exported = ex.export_inference_sharded(qmodel, H, W, 2, batch=4,
                                           path=path)
    meta = ex.read_meta(path)
    assert meta == exported.meta
    assert (meta["batch"], meta["rank_batch"], meta["nr_devices"]) == (4, 2,
                                                                       2)
    assert meta["ops"] == ["int8_conv", "upsample_argmax"]
    program = ex.load_exported(path)
    live = ex.make_serving_fn(qmodel)
    frames = _frames(22, 4)
    for part in np.split(frames, 2):
        np.testing.assert_array_equal(_run(program, part), _run(live, part))


def test_port_spatial_artifact_serves_any_batch_against_jax(
        pair, artifacts, tmp_path):  # noqa: F811
    path = artifacts["spatial"]
    meta = ex.read_meta(path)
    assert ex.artifact_shard_dim(path) == 1 and meta["nr_devices"] == 2
    assert not ex.is_bundle(path)
    assert meta["ops"] == ["halo_exchange", "spatial_sum",
                           "upsample_argmax_window"]
    batches = [torch.from_numpy(_frames(seed, b, SH, SW))
               for seed, b in ((23, 1), (24, 3))]
    ranks = run_ranks(spatial_programs, tmp_path, world=2, path=path,
                      frames=batches)
    for i, frames in enumerate(batches):
        got = torch.cat([bands[i][0] for bands in ranks], 1).numpy()
        assert got.shape == (frames.shape[0], SH, SW)
        assert all(bands[i][1] > 0 for bands in ranks)
        assert np.mean(got == _jax_labels(pair, frames.numpy())) >= AGREE


def test_port_spatial_export_refuses_an_unshardable_height(
        pair):  # noqa: F811
    _, _, model, _ = pair
    with pytest.raises(ValueError, match="not spatially shardable"):
        ex.export_inference_spatial(model, 96, SW, 2)


def test_port_spatial_int8_all_artifact_equals_banded_predict(
        pair, tmp_path):  # noqa: F811
    _, _, model, _ = pair
    rng = np.random.default_rng(25)
    batches = [torch.from_numpy(rng.standard_normal((2, 3, SH, SW))).float()]
    qmodel, _ = q.quantize_model(model, batches)
    path = str(tmp_path / "int8_spatial.zip")
    ex.export_inference_spatial(qmodel, SH, SW, 2, path=path)
    assert "int8_conv" in ex.read_meta(path)["ops"]
    frames = torch.from_numpy(_frames(26, 2, SH, SW))
    images = ex.make_serving_fn(qmodel).normalise(frames)
    programs = run_ranks(spatial_programs, tmp_path, world=2, path=path,
                         frames=[frames])
    live = run_ranks(spatial_predict, tmp_path, world=2, model=qmodel,
                     images=images)
    for bands, want in zip(programs, live):
        assert torch.equal(bands[0][0], want)


def _png_tree(root, frames):
    os.makedirs(root)
    for i, a in enumerate(frames):
        Image.fromarray(a).save(os.path.join(root, f"f{i}.png"))


def _served(out, n):
    return np.stack([np.asarray(Image.open(os.path.join(
        out, f"f{i}_trainIds.png"))) for i in range(n)])


def test_port_serve_runner_batch_sharded_over_two_ranks(
        artifacts, tmp_path):
    frames = _frames(27, 3)
    images, out = str(tmp_path / "images"), str(tmp_path / "out")
    _png_tree(images, frames)
    stats = serve.main([artifacts["sharded"], "--images", images,
                        "--output", out, "--batch_size", "3", "--device",
                        "cpu,cpu"])
    # the batch rounds up to whole ranks: 4, the tail padded
    assert (stats["images"], stats["batch_size"], stats["ranks"]) == (3, 4, 2)
    assert stats["shard_dim"] == 0
    one = ex.load_exported(artifacts["one"])
    padded = np.concatenate([frames, np.zeros_like(frames[:1])])
    want = np.concatenate([_run(one, part) for part in np.split(padded, 2)])
    np.testing.assert_array_equal(_served(out, 3), want[:3])


def test_port_serve_runner_spatial_over_two_ranks(pair, artifacts,
                                                  tmp_path):  # noqa: F811
    _, _, model, _ = pair
    frames = _frames(28, 3, SH, SW)
    images, out = str(tmp_path / "images"), str(tmp_path / "out")
    _png_tree(images, frames)
    stats = serve.main([artifacts["spatial"], "--images", images,
                        "--output", out, "--batch_size", "2", "--device",
                        "cpu,cpu"])
    # any batch: no rounding to the ranks
    assert (stats["images"], stats["batch_size"], stats["ranks"]) == (3, 2, 2)
    assert stats["shard_dim"] == 1 and stats["exchanges"] > 0
    want = _run(ex.make_serving_fn(model), frames)
    assert np.mean(_served(out, 3) == want) >= AGREE


def test_port_serve_runner_stops_on_too_few_devices(artifacts, tmp_path):
    images = str(tmp_path / "images")
    _png_tree(images, _frames(29, 1))
    with pytest.raises(SystemExit, match="pod artifact needs 2 devices, "
                                         "this host presents 1"):
        serve.main([artifacts["spatial"], "--images", images, "--output",
                    str(tmp_path / "out"), "--device", "cpu"])
    assert not os.path.exists(str(tmp_path / "out"))
