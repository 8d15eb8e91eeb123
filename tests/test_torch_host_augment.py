"""The port's host augmentation against the JAX package's, on the CPU.

* The port's vendored ``native/augment.cpp`` against the JAX package's
  ``native/augment.cpp`` (the source of the ``dseg_aug_*`` entry points
  of its ``libdsegloader.so``), built the way the JAX Makefile builds it
  but on its own, into a temporary directory: equal output, entry point
  by entry point, the fused menus included, and the hue tables over every
  reachable ``(uv, maxc)`` pair and the whole RGB cube.
* The port's ``HostAugment`` (native) and its numpy plain version
  (``augment_pil_exact`` + ``host_augment.apply_family_label``) against
  JAX ``HostAugment`` on one dataset, seed, epochs and indices, bit for
  bit, for every menu with ``augment_labels`` on and off.
* The library is named by a digest of its source: a changed byte gives
  another path, so a stale build is never loaded (the JAX package's
  fused-menu test skips on a stale ``.so`` instead,
  tests/test_native_augment.py:94). A source that does not compile
  raises with g++'s message.
"""

import ctypes
import os
import shutil

import numpy as np
import pytest

from dasemanticsegmentationaml_tpu.data import host_augment as jax_host
from dasemanticsegmentationaml_tpu.data import native as jax_native
from dasemanticsegmentationaml_tpu_torch.data import augment_pil_exact as px
from dasemanticsegmentationaml_tpu_torch.data import host_augment
from dasemanticsegmentationaml_tpu_torch.data import native_augment as na
from dasemanticsegmentationaml_tpu_torch.data.datasets import Subset
from dasemanticsegmentationaml_tpu_torch.data.pipeline import Loader
from dasemanticsegmentationaml_tpu_torch.ops.cuda.build import build_library

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SOURCE = os.path.join(REPO, "dasemanticsegmentationaml_tpu", "native",
                          "augment.cpp")
MENUS = ("CS-HF", "H-RP", "B-GS-R")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """(port, jax): the port's library and one built from the JAX
    package's source with the same flags, both bound by ``na.bind``."""
    path = str(tmp_path_factory.mktemp("jax_native") / "libjaxaug.so")
    build_library([na.gxx_path(), *na.GXX_FLAGS], JAX_SOURCE, path)
    return na.library(), na.bind(ctypes.CDLL(path))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def _run(lib, name, src, out_shape, *args):
    src = np.ascontiguousarray(src)
    out = np.empty(out_shape, np.uint8)
    h, w = src.shape[:2]
    assert getattr(lib, name)(_u8p(src), _u8p(out), h, w, *args) == 0
    return out


def _each_lib(libs, name, src, out_shape, *args):
    port, jax = (_run(lib, name, src, out_shape, *args) for lib in libs)
    assert np.array_equal(port, jax), name
    return port


def test_entry_points_match_the_jax_library(libs):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    lab = rng.integers(0, 35, (37, 53), dtype=np.uint8)
    f32 = lambda v: ctypes.c_float(np.float32(v))  # noqa: E731
    coeffs = np.array(host_augment.perspective_coeffs(
        *host_augment.sample_perspective_endpoints(rng, 37, 53)), np.float64)
    cp = coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    for mode, factor in ((0, 1.7), (1, 3.3), (2, 0.4), (2, 2.9)):
        out = _each_lib(libs, "dseg_aug_blend", img, img.shape, mode,
                        f32(factor))
        want = {0: px.adjust_brightness, 1: px.adjust_contrast,
                2: px.adjust_saturation}[mode](img, factor)
        np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(
        _each_lib(libs, "dseg_aug_gray3", img, img.shape),
        px.to_grayscale3(img))
    for shift in (0, 13, 200):
        _each_lib(libs, "dseg_aug_hue", img, img.shape, shift)
    for ch, src in ((3, img), (1, lab[..., None])):
        out = _each_lib(libs, "dseg_aug_perspective_bilinear",
                        np.ascontiguousarray(src), src.shape, ch, cp, 7)
        np.testing.assert_array_equal(
            out, px.perspective_bilinear(src, coeffs, fill=7))
    out = _each_lib(libs, "dseg_aug_perspective_nearest", lab, lab.shape,
                    cp, 255)
    np.testing.assert_array_equal(
        out, host_augment.warp_nearest_label(lab, coeffs))
    starts = [ctypes.c_int64(v) for v in
              px.rotate_fixed_point_starts(-41.5, 53, 37)]
    for ch, src in ((3, img), (1, lab[..., None])):
        out = _each_lib(libs, "dseg_aug_affine_nearest_fixed",
                        np.ascontiguousarray(src), src.shape, ch, *starts, 9)
        np.testing.assert_array_equal(
            out, px.rotate_nearest(src, -41.5, fill=9))
    # the fused menus, against the three-op sequences they fuse
    out = _each_lib(libs, "dseg_aug_cs_hf_fused", img, img.shape, f32(3.1),
                    f32(1.8))
    np.testing.assert_array_equal(out, px.hflip(px.adjust_saturation(
        px.adjust_contrast(img, 3.1), 1.8)))
    gray = _each_lib(libs, "dseg_aug_bright_gray1", img, img.shape[:2],
                     f32(1.45))
    np.testing.assert_array_equal(
        gray, px.luma(px.adjust_brightness(img, 1.45)))
    out = _each_lib(libs, "dseg_aug_rotate_gray_rep3", gray, img.shape,
                    *starts, 0)
    np.testing.assert_array_equal(
        out, px.rotate_nearest(px.to_grayscale3(
            px.adjust_brightness(img, 1.45)), -41.5))


def _hue_grid():
    """Every reachable (uv, maxc) pair: each (maxc, minc) with the middle
    channel between them, red or blue the largest."""
    maxc, minc = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    keep = minc <= maxc
    maxc, minc = maxc[keep], minc[keep]
    trio = np.stack([maxc, (maxc + minc) // 2, minc], -1)
    return np.ascontiguousarray(np.concatenate([trio, trio[:, ::-1]])
                                .astype(np.uint8)[None])


def test_hue_tables_cover_every_reachable_pair(libs):
    """The vendored library fills the saturation table only where
    uv <= maxc; on every reachable pair it equals the JAX library at every
    shift and Pillow's numpy twin at every 17th; on the whole RGB cube it
    equals the JAX library at six shifts."""
    grid = _hue_grid()
    hsv = px.rgb2hsv(grid)
    for shift in range(256):
        got = _each_lib(libs, "dseg_aug_hue", grid, grid.shape, shift)
        if shift % 17 == 0:
            shifted = hsv.copy()
            shifted[..., 0] = (hsv[..., 0].astype(np.int32) + shift) % 256
            np.testing.assert_array_equal(got, px.hsv2rgb(shifted),
                                          err_msg=f"shift {shift}")
    cube = np.arange(2**24, dtype=np.uint32)
    cube = np.stack([cube >> 16, (cube >> 8) & 255, cube & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 3)
    for shift in (0, 1, 51, 128, 204, 255):
        _each_lib(libs, "dseg_aug_hue", cube, cube.shape, shift)


class _Frames:
    """An in-memory dataset of uint8 (image, label) pairs that records
    the epochs passed to it."""

    def __init__(self, n=6, h=40, w=56, seed=0):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
        self.labels = rng.integers(0, 35, (n, h, w), dtype=np.uint8)
        self.epochs = []

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return self.images[idx], self.labels[idx]

    def set_epoch(self, epoch):
        self.epochs.append(epoch)


@pytest.fixture
def no_jax_rebuild(monkeypatch):
    """The JAX package loads its libdsegloader.so where it is built, and
    otherwise runs numpy (the same bits); it is never rebuilt in place."""
    monkeypatch.setattr(jax_native, "_build", lambda: False)


@pytest.mark.parametrize("augment_labels", [False, True])
@pytest.mark.parametrize("aug_type", MENUS)
def test_host_augment_matches_jax(aug_type, augment_labels, no_jax_rebuild):
    data = _Frames()
    ours = host_augment.HostAugment(data, aug_type, seed=3,
                                    augment_labels=augment_labels)
    theirs = jax_host.HostAugment(data, aug_type, seed=3,
                                  augment_labels=augment_labels)
    applied = 0
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for idx in range(len(data)):
            got_img, got_lab = ours[idx]
            want_img, want_lab = theirs[idx]
            np.testing.assert_array_equal(got_img, want_img)
            np.testing.assert_array_equal(got_lab, want_lab)
            # the plain version: numpy on the port's own draw
            p = host_augment.sample_params(
                aug_type, host_augment.rng_for(3, epoch, idx), 40, 56)
            np.testing.assert_array_equal(
                px.apply_family(data.images[idx], aug_type, p), got_img)
            if augment_labels:
                np.testing.assert_array_equal(host_augment.apply_family_label(
                    data.labels[idx], aug_type, p), got_lab)
            else:
                np.testing.assert_array_equal(data.labels[idx], got_lab)
            applied += p["applied"]
    assert 0 < applied < 2 * len(data)
    assert data.epochs == [0, 0, 1, 1]  # both wrappers pass the epoch on
    assert ours.aug_type is None


def test_loader_passes_the_epoch_through_a_subset():
    """Loader.set_epoch -> HostAugment -> Subset -> dataset (JAX
    pipeline.py:171-177 and Subset's __getattr__), so another epoch
    draws other augmentations."""
    data = _Frames(n=8)
    sub = Subset(data, [5, 1, 6, 2])
    wrapped = host_augment.HostAugment(sub, "CS-HF", seed=1)
    loader = Loader(wrapped, 4, num_workers=2)
    loader.set_epoch(0)
    first = next(iter(loader))[0]
    loader.set_epoch(4)
    second = next(iter(loader))[0]
    assert data.epochs == [0, 4] and wrapped._epoch == 4
    assert not np.array_equal(first.numpy(), second.numpy())
    assert Subset(data, [0]).images is data.images


def test_library_is_named_by_its_source(tmp_path):
    """A changed byte of the source changes the digest and the path; the
    loaded library is the one named by the checkout's source."""
    assert na.library()._name == na.library_path()
    copy = str(tmp_path / "augment.cpp")
    shutil.copy(na.SOURCE, copy)
    same = na.library_path(copy)
    assert os.path.basename(same) == os.path.basename(na.library_path())
    with open(copy, "r+b") as f:
        text = bytearray(f.read())
        text[text.index(b"0x8000")] = ord("1")  # 0x8000 -> 1x8000
        f.seek(0)
        f.write(text)
    changed = na.library_path(copy)
    assert changed != same and os.path.dirname(changed) == na.BUILD_DIR


def test_a_failed_build_raises_with_the_compiler_message(tmp_path):
    broken = tmp_path / "augment.cpp"
    broken.write_text(open(na.SOURCE).read() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error:"):
        build_library([na.gxx_path(), *na.GXX_FLAGS], str(broken),
                      str(tmp_path / "lib.so"))
    assert not os.path.exists(tmp_path / "lib.so")


def test_native_label_ops_take_uint8_only():
    with pytest.raises(TypeError):
        na.apply_family_label(np.zeros((4, 4), np.int32), "CS-HF",
                              {"applied": True})
