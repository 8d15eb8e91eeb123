"""``--data_cache`` (``data/cache.py``) of the port, on the CPU.

Mirrors JAX tests/test_cache.py on the port: cached samples are
byte-identical to the decode path's (and the Loader's batches over them),
an unchanged tree reuses its entry, a changed file gets a new one, the
GTA5 cache carries the remap and the augmentation menu under a split,
distinct subsets get distinct entries, numpy subset indices are accepted,
and only pair datasets are cached. Against the JAX package: the port's
fingerprint of a tree equals the JAX one (same ``_VERSION``, fields and
class names), and the port reads a cache the JAX package built, byte for
byte. Through the CLI: a supervised run with ``--data_cache`` reaches
exactly the mIoU of the run without it, and a warm rerun builds nothing.

Adds about 15 s alone on the CPU.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_eval import H, W, _mk_cityscapes, _mk_gtav

from dasemanticsegmentationaml_tpu.data import cache as jax_cache
from dasemanticsegmentationaml_tpu.data import datasets as jax_datasets
from dasemanticsegmentationaml_tpu_torch import cli
from dasemanticsegmentationaml_tpu_torch.data import cache as dcache
from dasemanticsegmentationaml_tpu_torch.data.datasets import (CityScapes,
                                                               GtaV, Subset)
from dasemanticsegmentationaml_tpu_torch.data.pipeline import Loader


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one CPU thread, as tests/test_torch_da.py runs it. The
    test command runs six workers on a few cores; there, on all of its
    intra-op threads, this file's small steps ran up to 100 times slower
    than in one process (threads waiting at every op's barrier)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cityscapes(tmp_path, mode="val", n=3):
    root = str(tmp_path / "cs")
    _mk_cityscapes(root, mode, n=n, size=(32, 64))
    return CityScapes(mode, root, height=32, width=64,
                      faithful_resize=False)


def test_cache_samples_bit_identical(tmp_path):
    ds = _cityscapes(tmp_path)
    cached = dcache.open_or_build(ds, str(tmp_path / "cache"))
    assert len(cached) == len(ds)
    assert cached.needs_remap is False and ds.needs_remap is False
    for i in range(len(ds)):
        img_d, lab_d = ds[i]
        img_c, lab_c = cached[i]
        np.testing.assert_array_equal(img_d, img_c)
        np.testing.assert_array_equal(lab_d, lab_c)
        assert img_c.dtype == np.uint8 and lab_c.dtype == np.uint8
    ld = Loader(ds, 2, shuffle=True, seed=7, num_workers=2)
    lc = Loader(cached, 2, shuffle=True, seed=7, num_workers=2)
    for (id_, ld_), (ic_, lc_) in zip(iter(ld), iter(lc)):
        np.testing.assert_array_equal(id_.numpy(), ic_.numpy())
        np.testing.assert_array_equal(ld_.numpy(), lc_.numpy())


def test_cache_reused_not_rebuilt(tmp_path, monkeypatch):
    ds = _cityscapes(tmp_path)
    root = str(tmp_path / "cache")
    dcache.open_or_build(ds, root)
    (entry,) = os.listdir(root)

    def boom(*a, **k):
        raise AssertionError("cache rebuilt for unchanged content")

    monkeypatch.setattr(dcache, "build_cache", boom)
    cached = dcache.open_or_build(ds, root)
    assert os.listdir(root) == [entry]
    np.testing.assert_array_equal(cached[0][0], ds[0][0])


def test_cache_invalidated_by_file_change(tmp_path):
    ds = _cityscapes(tmp_path)
    root = str(tmp_path / "cache")
    dcache.open_or_build(ds, root)
    lab_path = ds.pairs[0][1]
    Image.fromarray(np.full((32, 64), 5, dtype=np.uint8), mode="L").save(
        lab_path)
    os.utime(lab_path, ns=(1, 1))
    cached = dcache.open_or_build(ds, root)
    assert len(os.listdir(root)) == 2
    np.testing.assert_array_equal(cached[0][1], ds[0][1])


def test_gtav_cache_carries_remap_aug_and_splits(tmp_path):
    root = str(tmp_path / "gta")
    _mk_gtav(root, n=6, size=(32, 64))
    ds = GtaV(root, "CS-HF", height=32, width=64, faithful_resize=False)
    cached = dcache.open_or_build(ds, str(tmp_path / "cache"))
    assert cached.needs_remap is True
    assert cached.aug_type == "CS-HF"
    sub = Subset(cached, [4, 1])
    np.testing.assert_array_equal(sub[0][0], ds[4][0])
    np.testing.assert_array_equal(sub[1][1], ds[1][1])
    assert sub.needs_remap is True and sub.aug_type == "CS-HF"


def test_distinct_subsets_get_distinct_caches(tmp_path):
    ds = _cityscapes(tmp_path, n=4)
    root = str(tmp_path / "cache")
    a = dcache.open_or_build(Subset(ds, [0, 2]), root)
    b = dcache.open_or_build(Subset(ds, [1, 3]), root)
    full = dcache.open_or_build(ds, root)
    assert len(os.listdir(root)) == 3
    assert len(a) == len(b) == 2 and len(full) == 4
    np.testing.assert_array_equal(a[1][0], ds[2][0])
    np.testing.assert_array_equal(b[0][0], ds[1][0])


def test_fingerprint_accepts_numpy_subset_indices(tmp_path):
    ds = _cityscapes(tmp_path)
    assert (dcache.dataset_fingerprint(Subset(ds, np.array([1, 0],
                                                           np.int64)))
            == dcache.dataset_fingerprint(Subset(ds, [1, 0])))


def test_cache_requires_pair_datasets():
    with pytest.raises(TypeError):
        dcache.dataset_fingerprint([(np.zeros((2, 2, 3), np.uint8),
                                     np.zeros((2, 2), np.uint8))])


@pytest.mark.parametrize("kind", ["cityscapes", "gtav", "subset"])
def test_fingerprint_and_cache_are_the_jax_packages(tmp_path, kind):
    """One tree, both packages' datasets: the same fingerprint, so the
    same cache directory; the port opens the JAX-built cache and reads
    the JAX samples byte for byte."""
    if kind == "gtav":
        root = str(tmp_path / "gta")
        _mk_gtav(root, n=4, size=(32, 64))
        port = GtaV(root, None, 32, 64, faithful_resize=True)
        theirs = jax_datasets.GtaV(root, None, 32, 64, faithful_resize=True)
    else:
        root = str(tmp_path / "cs")
        _mk_cityscapes(root, "train", n=4, size=(32, 64))
        port = CityScapes("train", root, 32, 64, faithful_resize=False)
        theirs = jax_datasets.CityScapes("train", root, 32, 64,
                                         faithful_resize=False)
        if kind == "subset":
            port = Subset(port, np.array([3, 1]))
            theirs = jax_datasets.Subset(theirs, [3, 1])
    assert dcache.dataset_fingerprint(port) == \
        jax_cache.dataset_fingerprint(theirs)
    cache_root = str(tmp_path / "cache")
    built = jax_cache.open_or_build(theirs, cache_root, num_workers=1)

    def fail(*a, **k):
        raise AssertionError("the port rebuilt the JAX package's cache")

    real = dcache.build_cache
    dcache.build_cache = fail
    try:
        ours = dcache.open_or_build(port, cache_root)
    finally:
        dcache.build_cache = real
    assert ours.cache_dir == built.cache_dir
    assert len(ours) == len(port) and ours.needs_remap == port.needs_remap
    for i in range(len(ours)):
        for a, b, c in zip(ours[i], built[i], port[i]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_port_cli_with_cache_matches_without(tmp_path, monkeypatch):
    root = str(tmp_path / "cs")
    _mk_cityscapes(root, "train", n=4)
    _mk_cityscapes(root, "val", n=2)
    cache_dir = str(tmp_path / "cache")
    base = ["--root", root, "--crop_height", str(H), "--crop_width", str(W),
            "--batch_size", "2", "--eval_batch_size", "2",
            "--num_epochs", "2", "--max_steps_per_epoch", "1",
            "--validation_step", "1", "--checkpoint_step", "1",
            "--num_workers", "2", "--dtype", "float32",
            "--tensorboard", "False", "--cuda", "cpu"]
    r_plain = cli.main(base + ["--save_model_path", str(tmp_path / "a")])
    r_cache = cli.main(base + ["--save_model_path", str(tmp_path / "b"),
                               "--data_cache", cache_dir])
    assert r_plain["miou"] == pytest.approx(r_cache["miou"], abs=0.0)
    assert r_plain["precision"] == r_cache["precision"]
    entries = sorted(os.listdir(cache_dir))
    assert len(entries) == 2  # train + val
    types = set()
    for e in entries:
        with open(os.path.join(cache_dir, e, "manifest.json")) as f:
            types.add(json.load(f)["type"])
    assert types == {"CityScapes"}

    def boom(*a, **k):
        raise AssertionError("the warm run rebuilt a cache")

    monkeypatch.setattr(dcache, "build_cache", boom)
    r_warm = cli.main(base + ["--save_model_path", str(tmp_path / "c"),
                              "--data_cache", cache_dir])
    assert r_warm["miou"] == pytest.approx(r_plain["miou"], abs=0.0)
    assert sorted(os.listdir(cache_dir)) == entries
    for run in "abc":  # weights and states, 0.2 GB a run
        shutil.rmtree(tmp_path / run)
