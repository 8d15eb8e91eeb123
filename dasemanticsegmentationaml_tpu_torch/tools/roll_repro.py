"""The 16-bit roll that Mosaic could not lower, on the port's kernel.

Counterpart of the JAX package's ``tools/mosaic_roll_repro.py``: rolls the
repro's tile, ``arange(R * C)`` as float32 cast to each dtype, by 1 along
dim 1 through ``ops/cuda/tile_roll.py::tile_roll`` and prints
``<dtype>: ok`` when every bit equals numpy's ``np.roll`` of the same tile.
Unlike the JAX repro, which prints a failure and carries on, a mismatch or
a failed launch raises and the exit code is non-zero. ``--rows`` and
``--cols`` set another tile.

    python -m dasemanticsegmentationaml_tpu_torch.tools.roll_repro
    python -m dasemanticsegmentationaml_tpu_torch.tools.roll_repro --device cpu

Runs on ``cuda:0`` by default; ``--device cpu`` runs the plain version.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.cuda import tile_roll as tr

ROWS, COLS, SHIFT = 8, 128, 1
DTYPES = (torch.float32, torch.bfloat16, torch.int16, torch.int32)


def repro_tile(rows: int, cols: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """``jnp.arange(rows * cols, dtype=float32).reshape(rows, cols)
    .astype(dtype)``, as mosaic_roll_repro.py:31 builds it."""
    x = torch.arange(rows * cols, dtype=torch.float32).reshape(rows, cols)
    return x.to(dtype).to(device)


def bits(x: torch.Tensor) -> np.ndarray:
    """The bit patterns of ``x`` on the host."""
    return x.cpu().view(torch.int16 if x.element_size() == 2
                        else torch.int32).numpy()


def main(argv: Optional[List[str]] = None) -> Dict[str, str]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--rows", type=int, default=ROWS)
    parser.add_argument("--cols", type=int, default=COLS)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("roll_repro: no CUDA device; pass --device cpu for "
                         "the plain version")
    results = {}
    for dtype in DTYPES:
        name = str(dtype).replace("torch.", "")
        x = repro_tile(args.rows, args.cols, dtype, device)
        got = tr.tile_roll(x, SHIFT)
        want = np.roll(bits(x), SHIFT, axis=1)
        if got.shape != x.shape or got.dtype != dtype:
            raise AssertionError(f"{name}: got {tuple(got.shape)} {got.dtype}")
        if not np.array_equal(bits(got), want):
            raise AssertionError(f"{name}: tile_roll differs from np.roll "
                                 f"at shift {SHIFT}")
        print(f"{name}: ok", flush=True)
        results[name] = "ok"
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
