"""Copy-bandwidth probe: does a hand-written kernel stream device memory at
what torch's own copy does, and does TMA beat plain loads and stores?

Counterpart of the JAX package's ``tools/probe_pallas_dma.py`` (Pallas's
auto-pipelined row-block copy) and ``tools/probe_dma_manual.py`` (the same
copy driven by hand through a VMEM ring, or HBM to HBM), with the kernels
of ``ops/cuda/copy_probe.py``: ``copy_block``, ``copy_direct`` and
``copy_bounce`` (a TMA ring of 2 or 8 slots, over a sweep of chunk sizes).

    python -m dasemanticsegmentationaml_tpu_torch.tools.probe_copy
    python -m dasemanticsegmentationaml_tpu_torch.tools.probe_copy \\
        --device cpu --rows 64 --cols 256

The JAX probes' protocol on their buffer, 16384 x 8192 bf16 (256 MB) from a
seed: each variant is chained ``CHAIN`` = 8 times over two ping-pong
buffers (x -> a -> b -> a ...), one warm-up chain, then the best of
``REPS`` = 3 chains, timed with CUDA events around the whole chain. GB/s
counts the bytes read and written. The chain's last output must equal the
input bit for bit, or the probe raises. One line per variant, with the
share of the H100's 3.35 TB/s and the card's name and power limit. On the
CPU the plain version runs and the time is the host's clock: no device
figure.
"""

from __future__ import annotations

import argparse
import functools
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.cuda import copy_probe as cp

ROWS, COLS = 16384, 8192
CHAIN, REPS = 8, 3
#: device-memory rate of an H100 SXM (NVIDIA's data sheet), bytes/s
PEAK_BYTES_PER_S = 3.35e12
#: the chunk sizes swept for each ring depth, in KB
CHUNK_KB = {2: (16, 32, 64, 112), 8: (4, 8, 16, 28)}


def bounce_label(n_slots: int, chunk_bytes: int) -> str:
    return f"copy_bounce n_slots={n_slots} chunk={chunk_bytes // 1024} KB"


def variants() -> List[Tuple[str, Callable[..., torch.Tensor]]]:
    """(label, fn(src, out) -> out) of each variant the probe times."""
    out = [("copy_block", cp.copy_block), ("copy_direct", cp.copy_direct)]
    for n_slots in cp.SLOTS:
        for kb in CHUNK_KB[n_slots]:
            out.append((bounce_label(n_slots, kb * 1024), functools.partial(
                cp.copy_bounce, n_slots=n_slots, chunk_bytes=kb * 1024)))
    return out


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu (host clock)"
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    return rows[device.index or 0]


def run_chain(fn: Callable[..., torch.Tensor], x: torch.Tensor,
              bufs: List[torch.Tensor], chain: int) -> torch.Tensor:
    """x -> bufs[0] -> bufs[1] -> bufs[0] ... ``chain`` copies; the last
    output. ``fn(src, out)`` returns the tensor it wrote."""
    src = x
    for i in range(chain):
        src = fn(src, bufs[i % 2])
    return src


def time_chain(fn: Callable[..., torch.Tensor], x: torch.Tensor,
               bufs: List[torch.Tensor], chain: int = CHAIN,
               reps: int = REPS, bitwise: bool = True) -> float:
    """Best milliseconds of one chain of ``chain`` copies after a warm-up
    chain, whose output must equal ``x`` bit for bit (raises if not; with
    ``bitwise=False``, value for value, for ``x + 0``, which turns -0.0
    into +0.0). CUDA events on a card, the host's clock on the CPU."""
    got = run_chain(fn, x, bufs, chain)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    same = (torch.equal(got.view(torch.uint8), x.view(torch.uint8))
            if bitwise else torch.equal(got, x))
    if not same:
        raise AssertionError("the chain's output differs from its input")
    best = float("inf")
    for _ in range(reps):
        if x.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run_chain(fn, x, bufs, chain)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            run_chain(fn, x, bufs, chain)
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best


def seeded_buffer(rows: int, cols: int, device: torch.device,
                  seed: int = 0) -> torch.Tensor:
    """The probes' buffer: standard normal from ``seed``, in bf16."""
    x = np.random.default_rng(seed).standard_normal((rows, cols),
                                                    dtype=np.float32)
    return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Run the probe; returns each variant's milliseconds per copy."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--rows", type=int, default=ROWS)
    parser.add_argument("--cols", type=int, default=COLS)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_copy: no CUDA device; pass --device cpu for "
                         "the plain versions")
    card = card_line(device)
    x = seeded_buffer(args.rows, args.cols, device)
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    nbytes = x.numel() * x.element_size()
    print(f"probe_copy: {args.rows} x {args.cols} bf16 ({nbytes} bytes) on "
          f"{device}, chains of {CHAIN}, best of {REPS} | {card}", flush=True)
    results = {}
    for label, fn in variants():
        ms = time_chain(fn, x, bufs)
        per_copy = ms / CHAIN
        gbps = 2 * nbytes / (per_copy * 1e-3) / 1e9
        share = (f" = {gbps * 1e9 / PEAK_BYTES_PER_S:.3f} of 3.35 TB/s"
                 if device.type == "cuda" else "")
        print(f"{label}: {gbps:.1f} GB/s{share} ({per_copy:.4f} ms per "
              f"copy, chain {ms:.4f} ms); output bit-identical | {card}",
              flush=True)
        results[label] = per_copy
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
