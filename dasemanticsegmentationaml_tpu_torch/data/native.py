"""ctypes binding of the native decode + resize library (the loader's host
path).

Counterpart of ``dasemanticsegmentationaml_tpu/data/native.py``, bound to
the port's own copy of the source, ``native/loader.cpp``: libpng/libjpeg
decode with a Pillow-exact resize, BILINEAR for images and NEAREST for
labels, returning exactly what ``PIL.Image.resize`` returns
(tests/test_torch_native_loader.py). The library is built with g++ at
first use (the JAX Makefile's flags, linked with ``-lpng -ljpeg -lz``)
into ``build/native/``, named by a hash of the source, the flags and what
``-march=native`` means on this machine (``library_path``), as
``data/native_augment.py`` builds ``native/augment.cpp``; the JAX
package's own Makefile is never run. It is loaded with ``ctypes.CDLL``,
which releases the GIL during each call, so the loader's threads decode
in parallel.

Unlike the augmentation library, this one has a fallback, the JAX
package's: ``decode_resize`` returns None when the library could not be
built (the machine may lack the image libraries' headers) or declines a
file (an RGBA or 16-bit PNG, a corrupt file), and ``data/
transforms_host.py`` decodes with PIL instead, to the same bytes. A
failed build is kept, with the compiler's message (``unavailable_reason``),
and the CLI prints it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ..ops.cuda.build import build_library, source_digest
from .native_augment import BUILD_DIR, GXX_FLAGS, gxx_path, native_target

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "loader.cpp")
#: JAX native/Makefile's LDLIBS
LIBS = ("-lpng", "-ljpeg", "-lz")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_REASON: Optional[str] = None


def library_path(src: str = SOURCE) -> str:
    """Where the library built from ``src`` lives: named by the digest of
    the source, the flags, the libraries and ``native_target``."""
    digest = source_digest(src, (*GXX_FLAGS, *LIBS, native_target()))
    return os.path.join(BUILD_DIR, f"libdseg_loader_{digest}.so")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the two entry points' argument and result types (JAX
    native.py:55-71)."""
    lib.dseg_decode_resize.restype = ctypes.c_int
    lib.dseg_decode_resize.argtypes = [
        ctypes.c_char_p,                  # path
        ctypes.c_int,                     # out_w (0 = native size)
        ctypes.c_int,                     # out_h
        ctypes.c_int,                     # mode: 0 bilinear, 1 nearest
        ctypes.c_int,                     # grayscale
        ctypes.POINTER(ctypes.c_ubyte),   # out buffer
        ctypes.POINTER(ctypes.c_int),     # out w
        ctypes.POINTER(ctypes.c_int),     # out h
    ]
    lib.dseg_image_size.restype = ctypes.c_int
    lib.dseg_image_size.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def build(src: str = SOURCE, so_path: Optional[str] = None) -> str:
    """Build ``src`` into ``so_path`` (default ``library_path(src)``)
    unless it exists; returns the path. Raises with g++'s message."""
    so_path = so_path or library_path(src)
    build_library([gxx_path(), *GXX_FLAGS], src, so_path, libs=LIBS)
    return so_path


def library() -> Optional[ctypes.CDLL]:
    """The bound library, built at the first call; None when the build or
    the load failed (``unavailable_reason`` says why)."""
    global _LIB, _TRIED, _REASON
    if _TRIED:  # the loader's threads call this once a sample
        return _LIB
    with _LOCK:
        if not _TRIED:
            try:
                _LIB = bind(ctypes.CDLL(build()))
            except (OSError, RuntimeError, AttributeError,
                    subprocess.SubprocessError) as err:
                _REASON = str(err).strip()
            _TRIED = True
        return _LIB


def available() -> bool:
    return library() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library is not in use (the compiler's or the loader's
    message), or None when it is."""
    library()
    return _REASON


def decode_resize(path: str, size_wh: Optional[Tuple[int, int]],
                  interp: str, grayscale: bool = False
                  ) -> Optional[np.ndarray]:
    """Decode ``path`` and resize it to ``size_wh`` (PIL's (width,
    height); None keeps the file's size) with ``interp`` ('bilinear' or
    'nearest'); uint8 HWC, or HW when ``grayscale``. None when the
    library is unavailable or declines the file (JAX native.py:82-123)."""
    lib = library()
    if lib is None:
        return None
    if not path.lower().endswith((".png", ".jpg", ".jpeg")):
        return None
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    if size_wh is None:
        if lib.dseg_image_size(path.encode(), ctypes.byref(w),
                               ctypes.byref(h)) != 0:
            return None
        out_w, out_h = w.value, h.value
    else:
        out_w, out_h = int(size_wh[0]), int(size_wh[1])
    channels = 1 if grayscale else 3
    buf = np.empty((out_h, out_w, channels), dtype=np.uint8)
    mode = 1 if interp == "nearest" else 0
    rc = lib.dseg_decode_resize(
        path.encode(), out_w, out_h, mode, int(grayscale),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    if grayscale:
        return buf[..., 0]
    return buf
