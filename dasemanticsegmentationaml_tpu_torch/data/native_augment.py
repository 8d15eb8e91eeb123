"""ctypes binding of the native C++ augmentation ops (the --host_augment
hot path).

Counterpart of ``dasemanticsegmentationaml_tpu/data/native_augment.py``
(:32-233), bound to the port's own copy of the source,
``native/augment.cpp``: its nine ``dseg_aug_*`` entry points, the fused
menus ``dseg_aug_cs_hf_fused``, ``dseg_aug_bright_gray1`` and
``dseg_aug_rotate_gray_rep3`` included. The library is built with g++ at
first use (the JAX Makefile's flags, without the image libraries) into
``build/native/``, named by a hash of the source, the flags and what
``-march=native`` means on this machine (``library_path``), so a stale or
foreign build is never loaded. There is no numpy fallback: a failed build
raises with the compiler's message. ``apply_family`` and
``apply_family_label`` return exactly what ``augment_pil_exact.
apply_family`` and ``host_augment.apply_family_label`` return
(tests/test_torch_host_augment.py).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading

import numpy as np

from ..ops.cuda.build import BUILD_DIR as _KERNEL_BUILD_DIR
from ..ops.cuda.build import build_library, source_digest
from . import augment_pil_exact as px

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "augment.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_KERNEL_BUILD_DIR), "native")
#: JAX native/Makefile's CXXFLAGS (without -Wall) and -shared
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC",
             "-std=c++17", "-shared")

_LOCK = threading.Lock()
_LIB = None


def gxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the native augmentation "
                           "library cannot be built")
    return found


@functools.lru_cache(maxsize=None)
def native_target() -> str:
    """What ``-march=native`` expands to here (g++'s ``-###`` listing), so
    that a library built for another CPU is not loaded."""
    proc = subprocess.run([gxx_path(), "-march=native", "-###", "-E", "-"],
                          stdin=subprocess.DEVNULL, capture_output=True,
                          text=True, check=True)
    return proc.stderr


def library_path(src: str = SOURCE) -> str:
    """Where the library built from ``src`` lives: named by the digest of
    the source, the flags and ``native_target``."""
    digest = source_digest(src, (*GXX_FLAGS, native_target()))
    return os.path.join(BUILD_DIR, f"libdseg_augment_{digest}.so")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the nine entry points' argument and result types."""
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    f64p = ctypes.POINTER(ctypes.c_double)
    i, f, i64 = ctypes.c_int, ctypes.c_float, ctypes.c_int64
    signatures = {
        "dseg_aug_blend": [u8p, u8p, i, i, i, f],
        "dseg_aug_gray3": [u8p, u8p, i, i],
        "dseg_aug_hue": [u8p, u8p, i, i, i],
        "dseg_aug_perspective_bilinear": [u8p, u8p, i, i, i, f64p, i],
        "dseg_aug_perspective_nearest": [u8p, u8p, i, i, f64p, i],
        "dseg_aug_affine_nearest_fixed": [u8p, u8p, i, i, i] + [i64] * 6
                                         + [i],
        "dseg_aug_cs_hf_fused": [u8p, u8p, i, i, f, f],
        "dseg_aug_bright_gray1": [u8p, u8p, i, i, f],
        "dseg_aug_rotate_gray_rep3": [u8p, u8p, i, i] + [i64] * 6 + [i],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def library() -> ctypes.CDLL:
    """Build ``native/augment.cpp`` if needed and return the bound
    library. Raises on a failed build or load."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            build_library([gxx_path(), *GXX_FLAGS], SOURCE, path)
            _LIB = bind(ctypes.CDLL(path))
        return _LIB


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def _f32(value: float) -> ctypes.c_float:
    """The float32 factor the numpy twin uses (``np.float32(factor)``)."""
    return ctypes.c_float(np.float32(value))


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"native {what} failed with code {err}")


def _call3(fn, img: np.ndarray, *args) -> np.ndarray:
    src = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = src.shape[:2]
    out = np.empty_like(src)
    _check(fn(_u8p(src), _u8p(out), h, w, *args), fn.__name__)
    return out


def _coeffs(coeffs) -> np.ndarray:
    return np.ascontiguousarray([float(v) for v in coeffs], np.float64)


def _fixed_point_starts(angle: float, w: int, h: int):
    """The six 16.16 starts/steps of Pillow's rotation, from the shared
    exact Python-int math."""
    return [ctypes.c_int64(int(v))
            for v in px.rotate_fixed_point_starts(float(angle), w, h)]


def perspective_bilinear(img: np.ndarray, coeffs, fill: int = 0
                         ) -> np.ndarray:
    """(H, W, 3) uint8 image."""
    src = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, ch = src.shape
    out = np.empty_like(src)
    c = _coeffs(coeffs)
    _check(library().dseg_aug_perspective_bilinear(
        _u8p(src), _u8p(out), h, w, ch,
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), int(fill)),
        "perspective warp")
    return out


def perspective_nearest_label(label: np.ndarray, coeffs,
                              fill: int = 255) -> np.ndarray:
    src = np.ascontiguousarray(label, dtype=np.uint8)
    h, w = src.shape
    out = np.empty_like(src)
    c = _coeffs(coeffs)
    _check(library().dseg_aug_perspective_nearest(
        _u8p(src), _u8p(out), h, w,
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), int(fill)),
        "nearest warp")
    return out


def rotate_nearest(img: np.ndarray, angle: float, fill: int = 0
                   ) -> np.ndarray:
    src = np.ascontiguousarray(img, dtype=np.uint8)
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    h, w, ch = src.shape
    out = np.empty_like(src)
    _check(library().dseg_aug_affine_nearest_fixed(
        _u8p(src), _u8p(out), h, w, ch, *_fixed_point_starts(angle, w, h),
        int(fill)), "rotation")
    return out[..., 0] if squeeze else out


def apply_family(img: np.ndarray, aug_type: str, params: dict
                 ) -> np.ndarray:
    """Native twin of ``augment_pil_exact.apply_family``, through the
    fused menus where they exist (JAX :169-217)."""
    if not params.get("applied", True):
        return np.ascontiguousarray(img, dtype=np.uint8).copy()
    lib = library()
    if aug_type == "CS-HF":
        return _call3(lib.dseg_aug_cs_hf_fused, img,
                      _f32(params["contrast"]), _f32(params["saturation"]))
    if aug_type == "H-RP":
        out = _call3(lib.dseg_aug_hue, img, px.hue_shift_u8(params["hue"]))
        return perspective_bilinear(out, params["coeffs"], fill=0)
    if aug_type == "B-GS-R":
        src = np.ascontiguousarray(img, dtype=np.uint8)
        h, w = src.shape[:2]
        gray = np.empty((h, w), np.uint8)
        _check(lib.dseg_aug_bright_gray1(
            _u8p(src), _u8p(gray), h, w, _f32(params["brightness"])),
            "brightness + gray")
        # rotate the one gray plane and replicate it in the same pass:
        # nearest rotation permutes pixels and fills 0 -> 0, so it
        # commutes with the replication
        out = np.empty((h, w, 3), np.uint8)
        _check(lib.dseg_aug_rotate_gray_rep3(
            _u8p(gray), _u8p(out), h, w,
            *_fixed_point_starts(params["angle"], w, h), 0),
            "rotation + replication")
        return out
    raise ValueError(f"unknown aug_type {aug_type!r}")


def apply_family_label(label: np.ndarray, aug_type: str, params: dict,
                       fill: int = 255) -> np.ndarray:
    """Native twin of ``host_augment.apply_family_label`` (uint8 labels;
    JAX :220-233)."""
    if label.dtype != np.uint8:
        raise TypeError(f"native label ops take uint8, got {label.dtype}")
    if not params.get("applied", True):
        return np.ascontiguousarray(label).copy()
    if aug_type == "CS-HF":
        return np.ascontiguousarray(label)[:, ::-1].copy()
    if aug_type == "H-RP":
        return perspective_nearest_label(label, params["coeffs"], fill)
    if aug_type == "B-GS-R":
        return rotate_nearest(label, params["angle"], fill=fill)
    raise ValueError(f"unknown aug_type {aug_type!r}")
