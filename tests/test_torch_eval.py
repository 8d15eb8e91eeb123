"""The port's eval slice against the JAX package, on the CPU.

Batch preparation, the metrics, the dataset scanners and the flag surface
are held against their JAX counterparts; the slice as a whole is the
port's ``--domain_shift`` CLI against the JAX CLI on one synthetic tree
and one ``.pth`` written by the JAX package. Their precision and mIoU
must agree within 1e-3: at 4 x 64 x 128 pixels that allows about 30
predictions flipped by fp32 rounding (one flip moves precision by
1/32768), while a 1e-4 bound would fail on a handful of flips.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from dasemanticsegmentationaml_tpu import cli as jax_cli
from dasemanticsegmentationaml_tpu.data import datasets as jax_datasets
from dasemanticsegmentationaml_tpu.data.pipeline import (
    prepare_batch as jax_prepare_batch)
from dasemanticsegmentationaml_tpu.models.bisenet import BiSeNet as JaxBiSeNet
from dasemanticsegmentationaml_tpu.ops import metrics as jax_metrics
from dasemanticsegmentationaml_tpu.utils import torch_io
from dasemanticsegmentationaml_tpu.utils.config import (
    build_parser as jax_build_parser)
from dasemanticsegmentationaml_tpu_torch import cli
from dasemanticsegmentationaml_tpu_torch.data import datasets
from dasemanticsegmentationaml_tpu_torch.data.pipeline import (Loader,
                                                               prepare_batch)
from dasemanticsegmentationaml_tpu_torch.ops import metrics
from dasemanticsegmentationaml_tpu_torch.utils.config import build_parser

H, W = 64, 128


def _mk_cityscapes(root, mode, n=4, size=(H, W)):
    """tests/test_cli.py::_mk_cityscapes."""
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "images", mode, "city"), exist_ok=True)
    os.makedirs(os.path.join(root, "gtFine", mode, "city"), exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)
                        ).save(os.path.join(root, "images", mode, "city",
                                            f"c_{i:03d}.png"))
        Image.fromarray(rng.integers(0, 19, size, dtype=np.uint8), mode="L"
                        ).save(os.path.join(root, "gtFine", mode, "city",
                                            f"c_{i:03d}_labelTrainIds.png"))


def _mk_gtav(root, n=6, size=(H, W)):
    """tests/test_cli.py::_mk_gtav: palettised raw GTA5 ids."""
    rng = np.random.default_rng(1)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)
                        ).save(os.path.join(root, "images", f"{i:05d}.png"))
        lab = Image.fromarray(rng.integers(0, 35, size, dtype=np.uint8),
                              mode="P")
        lab.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tolist())
        lab.save(os.path.join(root, "labels", f"{i:05d}.png"))


def _seeded_pth(path):
    """A .pth of seeded BiSeNet weights, written by the JAX package."""
    model = JaxBiSeNet(n_classes=19)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        method=JaxBiSeNet.full_init))
    rng = np.random.default_rng(0)

    def fill(p, leaf):
        name = p[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            v = rng.standard_normal(leaf.shape) * np.sqrt(2.0 / fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name == "var":
            v = 0.5 + rng.random(leaf.shape)
        else:
            v = 0.1 * rng.standard_normal(leaf.shape)
        return v.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    torch_io.write_torch_checkpoint(
        path, torch_io.variables_to_torch_state(variables))


@pytest.mark.parametrize("remap", [False, True])
def test_prepare_batch_matches_jax(remap):
    """Exact against the JAX function's own ops run op by op; XLA's fused
    CPU code for the jitted function rounds up to 2 ulp differently, so
    that one is held within 1e-6 (values lie in [-2.2, 2.7])."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 8, 16, 3), dtype=np.uint8)
    labels = rng.integers(0, 35 if remap else 19, (2, 8, 16), dtype=np.uint8)
    args = (jnp.asarray(images), jnp.asarray(labels))
    with jax.disable_jit():
        want_i, want_l = jax_prepare_batch(*args, remap=remap)
    jit_i, _ = jax_prepare_batch(*args, remap=remap)
    got_i, got_l = prepare_batch(torch.from_numpy(images),
                                 torch.from_numpy(labels),
                                 device=torch.device("cpu"), remap=remap)
    assert got_i.shape == (2, 3, 8, 16) and got_i.dtype == torch.float32
    assert got_l.dtype == torch.int32
    got_nhwc = got_i.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got_nhwc, np.asarray(want_i))
    np.testing.assert_allclose(got_nhwc, np.asarray(jit_i), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_prepare_batch_dtype_and_memory_format():
    images = np.zeros((2, 8, 16, 3), np.uint8)
    labels = np.zeros((2, 8, 16), np.uint8)
    got, _ = prepare_batch(images, labels, device=torch.device("cpu"),
                           dtype=torch.bfloat16,
                           memory_format=torch.channels_last)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("shape,hi", [((3, 16, 32), 19), ((2, 40, 40), 256)])
def test_confusion_matrix_matches_jax(shape, hi):
    """hi=256 puts the 255 ignore label (and other out-of-range ids) in."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, hi, shape).astype(np.int32)
    preds = rng.integers(0, 19, shape).astype(np.int32)
    want = np.asarray(jax_metrics.confusion_matrix(
        jnp.asarray(labels), jnp.asarray(preds), 19))
    got = metrics.confusion_matrix(torch.from_numpy(labels),
                                   torch.from_numpy(preds), 19)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 19, (2, 16, 32)).astype(np.int32)
    labels[0, :4] = 255
    preds = np.where(rng.random(labels.shape) < 0.5, labels,
                     rng.integers(0, 19, labels.shape)).astype(np.int32)
    preds = np.where(labels == 255, 3, preds).astype(np.int32)
    jl, jp = jnp.asarray(labels), jnp.asarray(preds)
    tl, tp = torch.from_numpy(labels), torch.from_numpy(preds)
    hist = metrics.confusion_matrix(tl, tp, 19)
    np.testing.assert_allclose(
        metrics.per_class_iou(hist).numpy(),
        np.asarray(jax_metrics.per_class_iou(
            jax_metrics.confusion_matrix(jl, jp, 19))), rtol=1e-6)
    np.testing.assert_allclose(
        metrics.global_pixel_accuracy(tl, tp).item(),
        float(jax_metrics.global_pixel_accuracy(jl, jp)), rtol=1e-6)
    np.testing.assert_allclose(
        metrics.global_pixel_accuracy_masked(tl, tp, 19).item(),
        float(jax_metrics.global_pixel_accuracy_masked(jl, jp, 19)),
        rtol=1e-6)


def test_datasets_match_jax(tmp_path):
    cs, gta = str(tmp_path / "cs"), str(tmp_path / "gta")
    _mk_cityscapes(cs, "val", n=3)
    _mk_gtav(gta, n=6)
    for faithful in (True, False):
        got = datasets.CityScapes("val", cs, 32, 48, faithful_resize=faithful)
        want = jax_datasets.CityScapes("val", cs, 32, 48,
                                       faithful_resize=faithful)
        assert got.pairs == want.pairs and len(got) == 3
        for i in range(len(got)):
            for g, w in zip(got[i], want[i]):
                np.testing.assert_array_equal(g, w)
    got = datasets.GtaV(gta, None, H, W, faithful_resize=False)
    want = jax_datasets.GtaV(gta, None, H, W, faithful_resize=False)
    assert got.pairs == want.pairs
    np.testing.assert_array_equal(got[0][1], want[0][1])
    for n in (4, 6, 10, 37):
        assert datasets.train_val_split(n) == jax_datasets.train_val_split(n)


def test_loader_keeps_order_and_tail():
    data = [(np.full((2, 3, 3), i, np.uint8), np.full((2, 3), i, np.uint8))
            for i in range(5)]
    batches = list(Loader(data, 2, num_workers=3))
    assert [b[0].shape[0] for b in batches] == [2, 2, 1]
    order = [int(v) for images, _ in batches for v in images[:, 0, 0, 0]]
    assert order == list(range(5))
    assert batches[0][0].dtype == torch.uint8


def test_parser_matches_jax_flags():
    """Same flag names, defaults, types and choices as the JAX parser."""
    ours = {a.dest: a for a in build_parser()._actions}
    theirs = {a.dest: a for a in jax_build_parser()._actions}
    assert sorted(ours) == sorted(theirs)
    for dest, a in theirs.items():
        b = ours[dest]
        assert b.default == a.default, dest
        assert (b.choices is None) == (a.choices is None), dest
        if a.choices is not None:
            assert sorted(b.choices) == sorted(a.choices), dest
        if a.type is not None:
            assert b.type.__name__ == a.type.__name__, dest


@pytest.mark.parametrize("dataset", ["Cityspaces", "GTAV"])
def test_domain_shift_cli_matches_jax(tmp_path, dataset):
    """The slice end to end: the port's --domain_shift CLI against the JAX
    CLI, same tree, same .pth, fp32."""
    root = str(tmp_path / "data")
    if dataset == "GTAV":
        _mk_gtav(root)
    else:
        _mk_cityscapes(root, "val")
    pth = str(tmp_path / "best.pth")
    _seeded_pth(pth)
    argv = ["--root", root, "--dataset", dataset, "--domain_shift", "True",
            "--pretrain_path", pth, "--crop_height", str(H),
            "--crop_width", str(W), "--faithful_resize", "False",
            "--eval_batch_size", "2", "--num_workers", "1",
            "--dtype", "float32", "--tensorboard", "False"]
    want = jax_cli.main(argv + ["--num_devices", "1"])
    got = cli.main(argv + ["--cuda", "cpu"])
    assert abs(got["precision"] - want["precision"]) <= 1e-3
    assert abs(got["miou"] - want["miou"]) <= 1e-3
    assert 0.0 < got["miou"] <= 1.0


@pytest.mark.parametrize("flags", [
    # the DA path is ported; accumulation stops it as the JAX CLI does
    # (cli.py:603-611). The multi-device export cases that stopped here
    # run now: tests/test_torch_multi_device_cli.py::
    # test_port_cli_multi_device_exports
    ["--domain_adaptation", "True", "--iter_size", "2"],
])
def test_cli_stops_on_unported_paths(flags):
    argv = ["--domain_shift", "False", "--cuda", "cpu"] + flags
    with pytest.raises(SystemExit, match="--iter_size > 1 is supervised-only"):
        cli.main(argv)


@pytest.mark.parametrize("flags,match", [
    # cards --cuda to --cuda + 1, never the CPU
    (["--num_devices", "2", "--cuda", "0"], "CUDA is not available"),
    (["--num_processes", "2"], "needs --coordinator_address"),
    (["--coordinator_address", "localhost:1234"],
     "needs --num_processes > 1"),
    # JAX cli.py:164-207's refusals
    (["--num_processes", "2", "--process_id", "0", "--coordinator_address",
      "localhost:1234", "--sync_bn", "False"], "single-process only"),
    (["--num_processes", "2", "--process_id", "0", "--coordinator_address",
      "localhost:1234", "--num_devices", "4"], "cannot subset"),
    (["--domain_shift", "False", "--num_devices", "2", "--sync_bn", "False",
      "--batch_size", "3"], "divisible by the data-mesh size 2"),
    (["--domain_shift", "False", "--num_devices", "2", "--batch_size", "3"],
     "divisible by the process count 2"),
])
def test_cli_parallel_flags_reach_the_parallel_path(flags, match):
    """The data-parallel flags are read: each of these stops where the
    parallel path checks it, before any rank starts, with its reason."""
    if "--cuda" in flags and torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = ["--domain_shift", "True", "--cuda", "cpu"] + flags
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)


def test_cli_cuda_flag_never_falls_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(["--domain_shift", "True", "--cuda", "0",
                  "--root", str(tmp_path)])
