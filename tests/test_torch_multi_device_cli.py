"""int8 eval on the CLI's height-sharded mesh, and its multi-device
exports, on the CPU.

* ``--domain_shift True --quantize_int8 True --quantize_filter all
  --num_devices 2 --spatial_devices 2 --cuda cpu``: two gloo ranks
  calibrate whole and evaluate the int8 model in bands (each int8 block
  exchanges its halo, ``ops/quantize.py::QuantBlock``), against the
  port's one-process int8 CLI on the same tree and ``.pth``: mIoU and
  precision |Δ| <= 1e-3 (the one-process CLI is held to JAX's by
  ``tests/test_torch_quantize.py``).
* ``--export_model`` with the multi-device flags (each flag combination
  the port once stopped as not ported): the artifact is written
  and ``read_meta`` names its ranks and shard dim (``--export_spatial``
  with one device is the one-device export, as in JAX cli.py:566-575);
  the batch-sharded and the height-sharded artifacts, served by
  ``serve.main`` over two CPU ranks, label the val images as the
  certifying eval predicted them: bit for bit when each rank's batch is
  the eval's, on at least 0.999 of the pixels in bands (the banded fp32
  convolutions may round otherwise).

Each run's directory is deleted once read.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_distributed import _ranks_with_timeout
from test_torch_eval import _mk_cityscapes, _seeded_pth
from test_torch_export import AGREE, one_thread  # noqa: F401

from dasemanticsegmentationaml_tpu_torch import cli, serve
from dasemanticsegmentationaml_tpu_torch.train import evaluate as ev
from dasemanticsegmentationaml_tpu_torch.utils import export as ex

#: the crop: under --faithful_resize (the CLI's default) the loader's
#: tensors are 128 tall and 64 wide, which 2 spatial ranks shard
CROP = ["--crop_height", "64", "--crop_width", "128"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("tree")
    root = str(base / "data")
    _mk_cityscapes(root, "val")
    pth = str(base / "best.pth")
    _seeded_pth(pth)
    yield root, pth
    shutil.rmtree(str(base), ignore_errors=True)


def _argv(tree):
    root, pth = tree
    return ["--root", root, "--domain_shift", "True", "--pretrain_path",
            pth] + CROP + ["--eval_batch_size", "2", "--num_workers", "1",
                           "--dtype", "float32", "--tensorboard", "False",
                           "--cuda", "cpu"]


def test_port_int8_cli_on_the_mesh_matches_one_process(tree, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = _argv(tree) + ["--quantize_int8", "True", "--quantize_filter",
                          "all"]
    want = cli.main(argv)
    got = _ranks_with_timeout(argv + ["--num_devices", "2",
                                      "--spatial_devices", "2"])
    assert abs(got["miou"] - want["miou"]) <= 1e-3
    assert abs(got["precision"] - want["precision"]) <= 1e-3
    assert 0.0 < got["miou"] <= 1.0


@pytest.mark.parametrize("flags,ranks,dim", [
    (["--export_devices", "2", "--eval_scan_window", "8"], 2, 0),
    (["--quantize_int8", "True", "--export_spatial", "True"], 1, 0),
    (["--aug_type", "H-RP", "--host_augment", "True", "--profile_dir",
      "runs/trace", "--export_devices", "2"], 2, 0),
    (["--export_spatial", "True", "--export_devices", "2"], 2, 1),
    (["--export_devices", "4"], 4, 0),
])
def test_port_cli_multi_device_exports(tree, tmp_path, monkeypatch, flags,
                                       ranks, dim):
    """The artifact of each flag combination, and for the two-rank ones
    of the plain model, ``serve.main`` over two CPU ranks against the
    certifying eval's labels."""
    monkeypatch.chdir(tmp_path)
    seen = []
    confusion_matrix = ev.confusion_matrix

    def keep(labels, pred, num_classes):
        seen.append(pred.clone())
        return confusion_matrix(labels, pred, num_classes)

    monkeypatch.setattr(ev, "confusion_matrix", keep)
    art = str(tmp_path / ("m.zip" if dim else "m.pt2"))
    cli.main(_argv(tree) + ["--export_model", art] + flags)
    meta = ex.read_meta(art)
    assert meta.get("nr_devices", 1) == ranks
    assert ex.artifact_shard_dim(meta) == dim
    assert (meta["height"], meta["width"]) == (128, 64)
    assert ("int8_conv" in meta["ops"]) == ("--quantize_int8" in flags)
    assert not os.path.exists(str(tmp_path / "runs"))
    if ranks != 2 or "--aug_type" in flags:
        return
    images, out = str(tmp_path / "images"), str(tmp_path / "out")
    os.makedirs(images)
    root = os.path.join(tree[0], "images", "val", "city")
    names = sorted(os.listdir(root))
    for name in names:
        shutil.copy(os.path.join(root, name), images)
    # a chunk of 4: rank r serves eval batch r (batch-sharded); frames
    # resized to the artifact's 128 x 64, as the loader's faithful resize
    # of (64, 128) makes them
    stats = serve.main([art, "--images", images, "--output", out,
                        "--batch_size", "4", "--device", "cpu,cpu"])
    assert (stats["ranks"], stats["shard_dim"]) == (2, dim)
    got = np.stack([np.asarray(Image.open(os.path.join(
        out, name.replace(".png", "_trainIds.png")))) for name in names])
    want = torch.cat(seen).numpy()
    if dim == 0:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.mean(got == want) >= AGREE
