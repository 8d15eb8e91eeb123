"""Build a CUDA source of ``csrc/`` at first use and load it with ctypes.

Each source exposes a plain ``extern "C"`` launcher, so it compiles with
``nvcc`` alone in seconds; including PyTorch's headers would cost minutes
per build. The library lands in ``build/torch_kernels/`` beside the
package, named by a hash of the source, the local headers it includes and
the flags, so an edited source or header is rebuilt and an unchanged one
is loaded as it is. Nothing is compiled when a module is imported: the
first launch builds. ``source_digest`` and ``build_library`` also build
the host libraries of ``native/`` with g++ (``data/native_augment.py``,
``data/native.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Optional, Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_NAME_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
#: nvcc's output of the build made in this process (``-Xptxas -v``:
#: registers, shared memory and spills of each kernel), by source name
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_digest(src: str, flags: Sequence[str] = NVCC_FLAGS) -> str:
    """16 hex digits of SHA-256 over the source, every local header it
    includes (``#include "..."``, found beside the including file, each
    once, recursively) and the compiler flags."""
    h = hashlib.sha256()
    seen = set()
    pending = [os.path.abspath(src)]
    while pending:
        path = pending.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        h.update(text)
        pending += [os.path.normpath(os.path.join(os.path.dirname(path),
                                                  inc.decode()))
                    for inc in _LOCAL_INCLUDE.findall(text)]
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build_library(command: Sequence[str], src: str, so_path: str,
                  libs: Sequence[str] = ()) -> Optional[str]:
    """Compile ``src`` into ``so_path`` with ``command`` (the compiler and
    its flags), linking ``libs`` after the source, unless that file
    exists; return the compiler's output, or None when nothing was built.
    Raises with the compiler's message on a failed build. The library is
    written under a temporary name and renamed, so a process never loads
    a half-written file."""
    if os.path.exists(so_path):
        return None
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [*command, "-o", tmp, src, *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(cmd[0])} failed with code "
            f"{proc.returncode}: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so_path)
    return proc.stdout + proc.stderr


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library.

    Raises on a failed build or load; there is no fallback. Two sources
    build at once from two threads; one source builds once."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        so_path = os.path.join(BUILD_DIR,
                               f"lib{name}_{source_digest(src)}.so")
        output = build_library([nvcc_path(), *NVCC_FLAGS], src, so_path)
        if output is not None:
            BUILD_LOGS[name] = output
        lib = ctypes.CDLL(so_path)
        _LIBS[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card ``index`` (a persistent grid's
    size)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def current_stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``, for a launch."""
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def check_launch(err: int, what: str) -> None:
    """Raise on the CUDA error code a launcher returned."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
