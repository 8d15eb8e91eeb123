"""Build a CUDA source of ``csrc/`` at first use and load it with ctypes.

Each source exposes a plain ``extern "C"`` launcher, so it compiles with
``nvcc`` alone in seconds; including PyTorch's headers would cost minutes
per build. The library lands in ``build/torch_kernels/`` beside the
package, named by a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Nothing is compiled
when a module is imported: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

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
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so_path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so_path}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with code {proc.returncode}: "
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            BUILD_LOGS[name] = proc.stdout + proc.stderr
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        _LIBS[name] = lib
        return lib


def current_stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``, for a launch."""
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def check_launch(err: int, what: str) -> None:
    """Raise on the CUDA error code a launcher returned."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
