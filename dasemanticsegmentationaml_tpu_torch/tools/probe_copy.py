"""Copy-bandwidth probe: does a hand-written kernel stream device memory at
what torch's own copy does, and does TMA beat plain loads and stores?

Counterpart of the JAX package's ``tools/probe_pallas_dma.py`` (Pallas's
auto-pipelined row-block copy) and ``tools/probe_dma_manual.py`` (the same
copy driven by hand through a VMEM ring, or HBM to HBM), with the kernels
of ``ops/cuda/copy_probe.py``: ``copy_block`` (a plain grid);
``copy_direct`` (one span of whole 16 KB tiles per block, the next tile's
loads issued before this tile's stores), over spans of 1, 2 and 4 tiles
and a persistent grid; and ``copy_bounce`` (a TMA ring of 2 or 8 slots),
over every split of the ring between loads ahead and stores left unread
(``stores`` = 1 .. slots - 1), a sweep of chunk sizes, 1 and 2 issuing
blocks per SM (where two rings fit one SM's shared memory), and chunks
split over the blocks up front (the earlier ring at ``stores`` = 1) or claimed
as slots free up.

    python -m dasemanticsegmentationaml_tpu_torch.tools.probe_copy
    python -m dasemanticsegmentationaml_tpu_torch.tools.probe_copy \\
        --device cpu --rows 64 --cols 256

The JAX probes' protocol on their buffer, 16384 x 8192 bf16 (256 MB) from a
seed: each variant is chained ``CHAIN`` = 8 times over two ping-pong
buffers (x -> a -> b -> a ...), one warm-up chain, then the best of
``REPS`` = 3 chains, timed with CUDA events around the whole chain, the
wrappers' host path included (about one wrapper call per chain is not
hidden behind the card). On a card the same chain is also captured once in
a CUDA graph and replayed, best of ``REPS`` replays: device time only.
GB/s counts the bytes read and written. Every output must equal the input
bit for bit, or the probe raises. One line per variant, with the share of
the H100's 3.35 TB/s and the card's name and power limit, then the fastest
variant of each kernel by graph replay (the defaults of
``ops/cuda/copy_probe.py`` are chosen from it). On the CPU the plain
version runs and the time is the host's clock: no device figure.
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
#: the chunk sizes swept for each ring depth, in KB (a ring that does not
#: fit one SM's shared memory twice is swept at one block per SM only)
CHUNK_KB = {2: (16, 32, 56, 112), 8: (4, 8, 12, 16, 28)}
#: issuing blocks per SM swept for copy_bounce
BLOCKS_PER_SM = (1, 2)
#: tiles per block swept for copy_direct (0: the persistent grid)
DIRECT_TILES = (1, 2, 4, 0)


def direct_label(tiles_per_block: int = cp.DIRECT_TILES_PER_BLOCK) -> str:
    return f"copy_direct tiles_per_block={tiles_per_block or 'persistent'}"


def bounce_label(n_slots: int, ring: Optional[cp.Ring] = None) -> str:
    ring = ring or cp.BOUNCE_DEFAULTS[n_slots]
    return (f"copy_bounce n_slots={n_slots} stores={ring.stores} "
            f"chunk={ring.chunk_bytes // 1024} KB "
            f"blocks_per_sm={ring.blocks_per_sm} dynamic={int(ring.dynamic)}")


def rings(n_slots: int) -> List[cp.Ring]:
    """Every ring of the sweep at this depth."""
    return [cp.Ring(stores, kb * 1024, bps, dynamic)
            for stores in range(1, n_slots)
            for kb in CHUNK_KB[n_slots]
            for bps in BLOCKS_PER_SM
            if cp.ring_fits(n_slots, kb * 1024, stores, bps)
            for dynamic in (False, True)]


def variants() -> List[Tuple[str, Callable[..., torch.Tensor]]]:
    """(label, fn(src, out) -> out) of each variant the probe times."""
    out = [("copy_block", cp.copy_block)]
    for tiles in DIRECT_TILES:
        out.append((direct_label(tiles), functools.partial(
            cp.copy_direct, tiles_per_block=tiles)))
    for n_slots in cp.SLOTS:
        for ring in rings(n_slots):
            out.append((bounce_label(n_slots, ring), functools.partial(
                cp.copy_bounce, n_slots=n_slots, **ring._asdict())))
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


def _check_same(got: torch.Tensor, x: torch.Tensor, bitwise: bool) -> None:
    same = (torch.equal(got.view(torch.uint8), x.view(torch.uint8))
            if bitwise else torch.equal(got, x))
    if not same:
        raise AssertionError("the chain's output differs from its input")


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
    _check_same(got, x, bitwise)
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


def chain_graph(fn: Callable[..., torch.Tensor], x: torch.Tensor,
                bufs: List[torch.Tensor], chain: int = CHAIN,
                bitwise: bool = True) -> "torch.cuda.CUDAGraph":
    """The chain of ``chain`` copies on a card, captured once in a CUDA
    graph (the wrappers launch on the current stream, which the capture
    holds) after a warm-up chain; its first replay's output must equal
    ``x`` as in ``time_chain``. A replay launches the same kernels without
    the wrappers' host path."""
    run_chain(fn, x, bufs, chain)
    torch.cuda.synchronize(x.device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run_chain(fn, x, bufs, chain)
    bufs[(chain - 1) % 2].zero_()
    graph.replay()
    torch.cuda.synchronize(x.device)
    _check_same(got, x, bitwise)
    return graph


def time_graph(graph: "torch.cuda.CUDAGraph", reps: int = REPS) -> float:
    """Best milliseconds of one replay of ``graph``, by CUDA events."""
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def seeded_buffer(rows: int, cols: int, device: torch.device,
                  seed: int = 0) -> torch.Tensor:
    """The probes' buffer: standard normal from ``seed``, in bf16."""
    x = np.random.default_rng(seed).standard_normal((rows, cols),
                                                    dtype=np.float32)
    return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, float]]:
    """Run the probe; returns each variant's milliseconds per copy, by the
    chain (``"chain"``) and, on a card, by graph replay (``"graph"``)."""
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
    on_card = device.type == "cuda"
    for label, fn in variants():
        ms = time_chain(fn, x, bufs)
        per_copy = ms / CHAIN
        gbps = 2 * nbytes / (per_copy * 1e-3) / 1e9
        results[label] = {"chain": per_copy}
        share = graph = ""
        if on_card:
            share = f" = {gbps * 1e9 / PEAK_BYTES_PER_S:.3f} of 3.35 TB/s"
            results[label]["graph"] = time_graph(
                chain_graph(fn, x, bufs)) / CHAIN
            graph = (f"; graph replay {results[label]['graph']:.4f} ms "
                     f"per copy")
        print(f"{label}: {gbps:.1f} GB/s{share} ({per_copy:.4f} ms per "
              f"copy, chain {ms:.4f} ms{graph}); output bit-identical | "
              f"{card}", flush=True)
    by = "graph" if on_card else "chain"
    for kernel in ("copy_direct", "copy_bounce n_slots=2",
                   "copy_bounce n_slots=8"):
        best = min((r[by], label) for label, r in results.items()
                   if label.startswith(kernel))
        print(f"fastest {kernel}: {best[1]} ({best[0]:.4f} ms per copy, "
              f"by {'graph replay' if on_card else 'the chain'})",
              flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
