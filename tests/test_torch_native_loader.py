"""The port's native decoder (``data/native.py``, ``native/loader.cpp``),
on the CPU.

* The vendored ``native/loader.cpp`` against the JAX package's source
  (built with g++ into a temporary directory the way the port builds its
  copy, never in place): both entry points, ``dseg_image_size`` and
  ``dseg_decode_resize``, give the same return code and the same bytes on
  RGB, gray, palettised and RGBA PNGs, a JPEG, a corrupt and a truncated
  JPEG, and a PNG whose header claims 500000 x 500000 pixels.
* ``load_image`` / ``load_label`` through the native library against the
  PIL path (the library switched off), bit for bit, at the sizes and
  geometries of JAX tests/test_native.py.
* Eight threads decoding the same files at once give the single-threaded
  bytes.
* A failed build keeps g++'s message, decode falls back to PIL, and the
  CLI prints the message; the library is named by its source digest.

Adds about 13 s alone on the CPU (two g++ builds).
"""

import concurrent.futures as futures
import ctypes
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_eval import _mk_cityscapes

from dasemanticsegmentationaml_tpu_torch import cli
from dasemanticsegmentationaml_tpu_torch.data import native
from dasemanticsegmentationaml_tpu_torch.data import transforms_host as th
from dasemanticsegmentationaml_tpu_torch.ops.cuda.build import source_digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SOURCE = os.path.join(REPO, "dasemanticsegmentationaml_tpu", "native",
                          "loader.cpp")


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


def _huge_png(path):
    """tests/test_native.py::test_huge_header_png_survives's file."""
    def chunk(typ, payload):
        c = typ + payload
        return (struct.pack(">I", len(payload)) + c
                + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", 500000, 500000, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(b"\x00" * 10))
                + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """name -> (path, (w, h) or None for the huge header)."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    out = {}

    def save(name, img, **kw):
        path = str(d / name)
        img.save(path, **kw)
        out[name] = (path, img.size)

    save("rgb.png", Image.fromarray(
        rng.integers(0, 255, (37, 53, 3), dtype=np.uint8)))
    save("gray.png", Image.fromarray(
        rng.integers(0, 35, (37, 53), dtype=np.uint8), mode="L"))
    pal = Image.fromarray(rng.integers(0, 35, (41, 57), dtype=np.uint8),
                          mode="P")
    pal.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tolist())
    save("palette.png", pal)
    save("rgba.png", Image.fromarray(
        rng.integers(0, 255, (8, 8, 4), dtype=np.uint8), "RGBA"))
    save("image.jpg", Image.fromarray(
        rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)), quality=95)
    with open(out["image.jpg"][0], "rb") as f:
        data = f.read()
    for name, body in (("corrupt.jpg", b"\xff\xd8\xff\xe0not a real jpeg "
                        b"at all" * 3), ("truncated.jpg", data[:len(data) // 2])):
        with open(str(d / name), "wb") as f:
            f.write(body)
        out[name] = (str(d / name), (96, 64))
    _huge_png(str(d / "huge.png"))
    out["huge.png"] = (str(d / "huge.png"), None)
    return out


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The port's library and a temporary build of the JAX source."""
    path = str(tmp_path_factory.mktemp("jax_loader") / "libjaxloader.so")
    jax_lib = native.bind(ctypes.CDLL(native.build(JAX_SOURCE, path)))
    port_lib = native.library()
    assert port_lib is not None, native.unavailable_reason()
    return {"port": port_lib, "jax": jax_lib}


def _size(lib, path):
    w, h = ctypes.c_int(-1), ctypes.c_int(-1)
    rc = lib.dseg_image_size(path.encode(), ctypes.byref(w), ctypes.byref(h))
    return rc, w.value, h.value


def _decode(lib, path, out_wh, mode, gray, buf_wh):
    ch = 1 if gray else 3
    buf = np.full((buf_wh[1], buf_wh[0], ch), 0xA5, np.uint8)
    w, h = ctypes.c_int(-1), ctypes.c_int(-1)
    rc = lib.dseg_decode_resize(
        path.encode(), out_wh[0], out_wh[1], mode, gray,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.byref(w), ctypes.byref(h))
    return rc, w.value, h.value, buf


def test_vendored_copy_is_the_original_below_its_header():
    def body(path):
        with open(path) as f:
            text = f.read()
        return text[text.index("#include <png.h>"):]

    assert body(native.SOURCE) == body(JAX_SOURCE)


@pytest.mark.parametrize("name", ["rgb.png", "gray.png", "palette.png",
                                  "rgba.png", "image.jpg", "corrupt.jpg",
                                  "truncated.jpg", "huge.png"])
def test_entry_points_match_the_jax_library(libs, images, name):
    path, wh = images[name]
    sizes = [(24, 16), (100, 80)] + ([(0, 0)] if wh else [])
    assert _size(libs["port"], path) == _size(libs["jax"], path)
    rcs = set()
    for out_wh in sizes:
        buf_wh = wh if out_wh == (0, 0) else out_wh
        for mode in (0, 1):
            for gray in (0, 1):
                port = _decode(libs["port"], path, out_wh, mode, gray,
                               buf_wh)
                want = _decode(libs["jax"], path, out_wh, mode, gray,
                               buf_wh)
                assert port[:3] == want[:3], (out_wh, mode, gray)
                np.testing.assert_array_equal(port[3], want[3])
                rcs.add(port[0])
    # what the pipeline must decline is declined, the rest decoded
    if name in ("rgba.png", "corrupt.jpg", "huge.png"):
        assert 0 not in rcs, rcs
    elif name != "truncated.jpg":  # libjpeg may conceal or give up
        assert 0 in rcs, rcs


def _pil(monkeypatch, fn, *args):
    """``fn(*args)`` with the native library switched off: the PIL path."""
    with monkeypatch.context() as m:
        m.setattr(native, "decode_resize", lambda *a, **k: None)
        return fn(*args)


@pytest.mark.parametrize("size", [(24, 16), (100, 80), (53, 37), (64, 90)])
@pytest.mark.parametrize("faithful", [True, False])
def test_load_image_native_is_pil(images, monkeypatch, size, faithful):
    """JAX test_native.py::test_bilinear_exact_vs_pil's sizes, through
    ``load_image`` (out_hw is (height, width) before the faithful swap)."""
    path = images["rgb.png"][0]
    out_hw = (size[1], size[0])
    assert native.decode_resize(path, size, "bilinear") is not None
    got = th.load_image(path, out_hw, faithful)
    want = _pil(monkeypatch, th.load_image, path, out_hw, faithful)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["gray.png", "palette.png"])
@pytest.mark.parametrize("size", [(24, 16), (100, 80), None])
def test_load_label_native_is_pil(images, monkeypatch, name, size):
    path = images[name][0]
    out_hw = None if size is None else (size[1], size[0])
    assert native.decode_resize(path, size, "nearest",
                                grayscale=True) is not None
    got = th.load_label(path, out_hw, False)
    want = _pil(monkeypatch, th.load_label, path, out_hw, False)
    np.testing.assert_array_equal(got, want)


def test_nearest_geometries_and_jpeg_are_pil(tmp_path, images, monkeypatch):
    """JAX test_native.py's cumulative-index geometries for labels, the
    JPEG at its size, and declined files (RGBA) through PIL."""
    rng = np.random.default_rng(1)
    for (sw, sh), (dw, dh) in [((640, 480), (321, 241)),
                               ((640, 4), (333, 3)),
                               ((1999, 7), (777, 5))]:
        p = str(tmp_path / f"l_{sw}x{sh}.png")
        Image.fromarray(rng.integers(0, 35, (sh, sw), dtype=np.uint8),
                        mode="L").save(p)
        got = th.load_label(p, (dw, dh), True)  # faithful: PIL (dw, dh)
        want = _pil(monkeypatch, th.load_label, p, (dw, dh), True)
        assert got.shape == (dh, dw)
        np.testing.assert_array_equal(got, want)
    for name in ("image.jpg", "rgba.png"):
        path = images[name][0]
        np.testing.assert_array_equal(
            th.load_image(path), _pil(monkeypatch, th.load_image, path))
    assert native.decode_resize(images["rgba.png"][0], None,
                                "bilinear") is None


def test_eight_threads_decode_the_single_threaded_bytes(tmp_path):
    root = str(tmp_path / "cs")
    _mk_cityscapes(root, "train", n=4, size=(256, 512))
    files = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root)
                   for f in fs)
    jobs = [(p, "labelTrainIds" in p) for p in files] * 8

    def decode(job):
        path, label = job
        load = th.load_label if label else th.load_image
        return load(path, (128, 256), True)

    want = [decode(j) for j in jobs]
    with futures.ThreadPoolExecutor(8) as pool:
        got = list(pool.map(decode, jobs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not isinstance(native.library(), ctypes.PyDLL)  # GIL released


def test_failed_build_keeps_the_message_and_the_cli_prints_it(
        tmp_path, monkeypatch, capsys):
    bad = tmp_path / "loader.cpp"
    bad.write_text("#include <no_such_image_header.h>\n")
    build = native.build
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_REASON", None)
    monkeypatch.setattr(native, "build", lambda: build(
        str(bad), str(tmp_path / "libbad.so")))
    assert native.library() is None
    reason = native.unavailable_reason()
    assert "g++ failed" in reason and "no_such_image_header.h" in reason
    note = cli.native_decoder_note()
    assert "decoding with PIL" in note and "no_such_image_header.h" in note
    assert "\n" not in note
    # the CLI says so, and decodes with PIL
    root = str(tmp_path / "cs")
    _mk_cityscapes(root, "val", n=2)
    res = cli.main(["--domain_shift", "True", "--root", root,
                    "--crop_height", "64", "--crop_width", "128",
                    "--num_workers", "1", "--dtype", "float32",
                    "--cuda", "cpu"])
    assert 0.0 <= res["miou"] <= 1.0
    printed = capsys.readouterr().out
    assert printed.count("decoding with PIL") == 1
    assert "no_such_image_header.h" in printed


def test_library_is_named_by_its_source_digest(tmp_path):
    flags = (*native.GXX_FLAGS, *native.LIBS, native.native_target())
    path = native.library_path()
    assert os.path.basename(path) == (
        f"libdseg_loader_{source_digest(native.SOURCE, flags)}.so")
    copy = tmp_path / "loader.cpp"
    with open(native.SOURCE, "rb") as f:
        text = f.read()
    copy.write_bytes(text)
    assert native.library_path(str(copy)) == path
    copy.write_bytes(text + b"\n")
    assert native.library_path(str(copy)) != path
    assert native.library_path(JAX_SOURCE) != path
    assert cli.native_decoder_note() is None  # built here: no note
