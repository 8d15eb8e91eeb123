"""The port's serving runner (``serve.py``) and ``--export_model`` CLI
against the JAX package, on the CPU.

``serve.main`` on an artifact of the port against JAX ``serve.main`` on
JAX's artifact of the same weights (one JAX export for the module), over
a directory with a ragged tail, a subdirectory and a same-stem
``.jpg``/``.png`` pair: the same output names, labels equal on at least
0.999 of the pixels (the port runs the upsample+argmax kernel's plain
version, JAX the full forward and ``argmax``), and ``_color.png`` equal
to the palette of the labels. A bundle's ragged tail runs on the
smallest program that fits it. The device rules: ``--device cuda:0``
without a card stops, and so does an artifact of another device type.
The ``--domain_shift --export_model`` CLI writes an artifact whose
labels equal the certifying eval's predictions, fp32 and int8 ``all``.
"""

import json
import os
import shutil
import sys
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from dasemanticsegmentationaml_tpu import serve as jax_serve
from dasemanticsegmentationaml_tpu.utils import export as jax_export
from dasemanticsegmentationaml_tpu_torch import cli, serve
from dasemanticsegmentationaml_tpu_torch.data.datasets import CityScapes
from dasemanticsegmentationaml_tpu_torch.data.labels import train_id_colors
from dasemanticsegmentationaml_tpu_torch.data.pipeline import Loader
from dasemanticsegmentationaml_tpu_torch.models import BiSeNet
from dasemanticsegmentationaml_tpu_torch.train import evaluate as ev
from dasemanticsegmentationaml_tpu_torch.utils import export as ex

from test_torch_eval import _mk_cityscapes, _seeded_pth
from test_torch_export import AGREE, H, W, one_thread, pair  # noqa: F401


def _write_tree(root, seed=3):
    """Five 128x256 frames (resized to the artifact's 64x128) with a
    same-stem .jpg/.png pair, and one in a subdirectory whose stem
    collides with a top-level one: 6 images, a ragged tail at batch 4."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "sub"), exist_ok=True)
    names = ["f0.png", "f0.jpg", "f1.png", "f2.png", "f3.png",
             os.path.join("sub", "f0.png")]
    for name in names:
        img = Image.fromarray(rng.integers(0, 256, (128, 256, 3),
                                           dtype=np.uint8))
        img.save(os.path.join(root, name), quality=95)
    return names


def _outputs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def jax_artifact(pair, tmp_path_factory):  # noqa: F811
    jax_model, variables, _, _ = pair
    path = str(tmp_path_factory.mktemp("jax") / "m.shlo")
    jax_export.export_inference(jax_model, variables, H, W, path=path)
    return path


def test_port_serve_main_matches_jax_serve_main(
        pair, jax_artifact, tmp_path):  # noqa: F811
    _, _, model, _ = pair
    images = str(tmp_path / "images")
    _write_tree(images)
    art = str(tmp_path / "m.pt2")
    ex.export_inference(model, H, W, path=art)
    out_jax, out_port = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["--images", images, "--batch_size", "4", "--color"]
    want = jax_serve.main([jax_artifact, "--output", out_jax] + argv)
    got = serve.main([art, "--output", out_port, "--device", "cpu"] + argv)
    assert got["images"] == want["images"] == 6
    assert got["chunks_by_batch"] == {4: 2}
    names = _outputs(out_port)
    assert names == _outputs(out_jax)
    assert {"f0.jpg_trainIds.png", "f0.png_trainIds.png",
            os.path.join("sub", "f0_trainIds.png")} <= set(names)
    palette = train_id_colors()
    for name in names:
        if not name.endswith("_trainIds.png"):
            continue
        pred = np.asarray(Image.open(os.path.join(out_port, name)))
        ref = np.asarray(Image.open(os.path.join(out_jax, name)))
        assert np.mean(pred == ref) >= AGREE, name
        colour = np.asarray(Image.open(os.path.join(
            out_port, name.replace("_trainIds", "_color"))))
        np.testing.assert_array_equal(colour, palette[pred])


@pytest.mark.parametrize("n_images,batch_size,chunks", [
    (5, 4, {4: 1, 1: 1}),      # a tail of 1 on the b1 program
    (7, 4, {4: 2}),            # a tail of 3: the smallest that fits is 4
    (5, 3, {2: 2, 1: 1}),      # --batch_size 3: the largest <= 3 is 2
])
def test_port_serve_bundle_tail_uses_smallest_program(
        pair, tmp_path, n_images, batch_size, chunks):  # noqa: F811
    """A bundle of batches 1, 2 and 4: the steady state on the largest
    batch <= --batch_size, a ragged tail on the smallest program that fits
    it; the labels are the live module's."""
    _, _, model, _ = pair
    bundle = str(tmp_path / "b.zip")
    ex.export_inference_bundle(model, H, W, [1, 2, 4], path=bundle)
    images = str(tmp_path / "images")
    os.makedirs(images)
    rng = np.random.default_rng(n_images)
    for i in range(n_images):
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
                        ).save(os.path.join(images, f"i{i}.png"))
    out = str(tmp_path / "out")
    got = serve.main([bundle, "--images", images, "--output", out,
                      "--batch_size", str(batch_size), "--device", "cpu"])
    assert got["chunks_by_batch"] == chunks
    live = ex.make_serving_fn(model)
    frames = np.stack([np.asarray(Image.open(os.path.join(
        images, f"i{i}.png"))) for i in range(n_images)])
    with torch.inference_mode():
        want = live(torch.from_numpy(frames)).numpy()
    for i in range(n_images):
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(out, f"i{i}_trainIds.png"))),
            want[i])


def _with_device(src, dst, device_type):
    """A copy of the artifact ``src`` whose metadata names
    ``device_type``."""
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename.endswith(f"extra/{ex.META_NAME}"):
                data = json.dumps({**json.loads(data),
                                   "device": device_type}).encode()
            zout.writestr(item, data)


@pytest.mark.parametrize("case", ["no card", "other device type",
                                  "unknown device"])
def test_port_serve_device_rules(pair, tmp_path, case):  # noqa: F811
    """``--device cuda:0`` without a card stops (no CPU fallback); an
    artifact of another device type stops, naming both; a device the
    port has no kernels for stops."""
    _, _, model, _ = pair
    art = str(tmp_path / "m.pt2")
    ex.export_inference(model, H, W, batch=1, path=art)
    images = str(tmp_path / "images")
    os.makedirs(images)
    Image.fromarray(np.zeros((H, W, 3), np.uint8)).save(
        os.path.join(images, "a.png"))
    argv = ["--images", images, "--output", str(tmp_path / "out")]
    if case == "no card":
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(SystemExit, match="CUDA is not available"):
            serve.main([art, "--device", "cuda:0"] + argv)
    elif case == "other device type":
        other = str(tmp_path / "cuda.pt2")
        _with_device(art, other, "cuda")
        with pytest.raises(SystemExit, match="exported for cuda.*--device "
                                             "is cpu"):
            serve.main([other, "--device", "cpu"] + argv)
    else:
        with pytest.raises(SystemExit, match="expected 'cpu' or 'cuda"):
            serve.main([art, "--device", "mps"] + argv)
    assert not os.path.exists(str(tmp_path / "out"))


@pytest.mark.parametrize("extra", [
    [],
    ["--quantize_int8", "True", "--quantize_filter", "all",
     "--export_batches", "1,2"],
])
def test_port_cli_export_model_matches_certifying_eval(tmp_path, capsys,
                                                       monkeypatch, extra):
    """``--domain_shift --export_model`` on the CPU (fp32; the int8
    ``all`` model as a bundle): the artifact, at the orientation the
    loader produces under --faithful_resize, labels the val images as the
    certifying eval predicted them, bit for bit."""
    root = str(tmp_path / "data")
    _mk_cityscapes(root, "val")
    pth = str(tmp_path / "best.pth")
    _seeded_pth(pth)
    art = str(tmp_path / ("m.zip" if extra else "m.pt2"))
    seen = []
    confusion_matrix = ev.confusion_matrix

    def keep(labels, pred, num_classes):
        seen.append(pred.clone())
        return confusion_matrix(labels, pred, num_classes)

    monkeypatch.setattr(ev, "confusion_matrix", keep)
    cli.main(["--root", root, "--domain_shift", "True", "--pretrain_path",
              pth, "--crop_height", "64", "--crop_width", "128",
              "--eval_batch_size", "2", "--num_workers", "1", "--dtype",
              "float32", "--tensorboard", "False", "--cuda", "cpu",
              "--export_model", art] + extra)
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("exported serving artifact"))
    assert f"{os.path.getsize(art)} bytes, cpu" in line
    meta = ex.read_meta(art)
    assert (meta["height"], meta["width"]) == (128, 64)
    if extra:
        assert meta["batches"] == [1, 2]
        assert meta["ops"] == ["int8_conv", "upsample_argmax"]
        program = ex.read_exported_bundle(art)[2].program.module()
    else:
        assert meta["batch"] is None and meta["ops"] == ["upsample_argmax"]
        program = ex.load_exported(art)
    loader = Loader(CityScapes("val", root, 64, 128, faithful_resize=True), 2,
                    num_workers=1)
    with torch.inference_mode():
        got = [program(images) for images, _ in loader]
    assert len(got) == len(seen) == 2
    for g, want in zip(got, seen):
        assert torch.equal(g, want)


def test_port_console_main_and_list_images(tmp_path, monkeypatch):
    """``list_images`` walks the tree for .png/.jpg/.jpeg in sorted order;
    ``console_main`` returns 0 rather than the stats dict."""
    images = str(tmp_path / "images")
    names = _write_tree(images)
    with open(os.path.join(images, "notes.txt"), "w") as f:
        f.write("not an image")
    assert serve.list_images(images) == sorted(
        os.path.join(images, n) for n in names)
    art = str(tmp_path / "m.pt2")
    ex.export_inference(BiSeNet(19).eval(), H, W, path=art)
    out = str(tmp_path / "out")
    monkeypatch.setattr(sys, "argv", ["serve.py", art, "--images",
                                      images, "--output", out, "--device",
                                      "cpu"])
    assert serve.console_main() == 0
    assert len(_outputs(out)) == len(names)
    shutil.rmtree(out)


@pytest.mark.parametrize("flags,match", [
    (["--export_batches", "1,8", "--export_spatial", "True"],
     "cannot be combined"),
    # --export_devices 4 alone exports now (tests/test_torch_multi_device_
    # cli.py); with a bundle whose batch 4 does not divide, it stops
    (["--export_devices", "4", "--export_batches", "2,8"],
     "batch 2 not divisible by the 4-device mesh"),
    (["--export_devices", "2", "--export_spatial", "True", "--crop_height",
      "64", "--crop_width", "96"],
     "image height 96 is not spatially shardable over 2 devices"),
])
def test_port_cli_stops_on_the_multi_device_exports(flags, match):
    """The multi-device exports' refusals, in JAX's words and before any
    work: ``--export_batches`` with ``--export_spatial`` (JAX
    cli.py:503-512), a bundle batch the devices do not divide (JAX
    utils/export.py:158-160), a height the spatial artifact cannot shard
    (under --faithful_resize, --crop_width; JAX :252)."""
    with pytest.raises(SystemExit, match=match):
        cli.main(["--domain_shift", "True", "--cuda", "cpu",
                  "--export_model", "m.pt2"] + flags)
