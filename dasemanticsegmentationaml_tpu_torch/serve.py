"""Serving runner: replay an exported artifact over a directory of images.

Counterpart of ``dasemanticsegmentationaml_tpu/serve.py`` (:32-220). The
serving host runs

    python -m dasemanticsegmentationaml_tpu_torch.serve model.pt2 \\
        --images <dir> --output <dir> [--batch_size 8] [--color] \\
        [--device cuda:0 | --device cuda:0,cuda:1,...]

with only the artifact (``utils/export.py``): no checkpoint and no model
code. It imports the modules that register the artifact's custom ops
(``ops/cuda/upsample_argmax.py``, ``ops/cuda/int8_conv.py``,
``parallel/spatial.py``), the host decoder (``data/transforms_host.py``)
and the label palette, and nothing under ``models/``. Images decode and
resize on one host thread, a chunk ahead of the device; each image writes
``<stem>_trainIds.png`` (the Cityscapes gtFine trainId encoding) and, with
``--color``, ``<stem>_color.png`` in the train-id palette
(``data/labels.py``).

Three differences from JAX. ``--device`` (default ``cuda:0``, ``cpu`` on
request) must be the device the artifact was exported on: another type
(or a card other than the one its weights were saved on) stops with
``SystemExit`` naming both, and nothing is moved quietly; a missing card
stops too, there is no CPU fallback. On a card each
concrete batch size of the loaded program is captured once into a
``torch.cuda.CUDAGraph`` over a static uint8 input slot and replayed per
chunk (the counterpart of the one compiled executable per batch that
``exported.call`` dispatches); a failed capture raises.

A multi-device artifact (``nr_devices`` N > 1; JAX :65-108) is served by
N ranks of one process group, one a device of ``--device a,b,...``
(fewer than N stop with JAX's message; never fewer ranks): spawned as
``--num_devices`` spawns them (``parallel/distributed.py::spawn``: a
``file://`` store, a timeout on every join, a rank that dies stops the
run), over NCCL between distinct cards and gloo on the CPU or where one
card is named twice (two ranks sharing it). Rank 0 decodes a chunk,
scatters it on the artifact's shard dim (``artifact_shard_dim``: the
batch, rounded up to a multiple of N, or the image rows, any batch),
gathers the labels and writes the PNGs. Each rank runs its program: the
batch-sharded artifact's one program, or its own ``r<k>.pt2`` of a
spatial artifact, whose exchanges and sums run over the group through the
mesh the rank registers (``parallel/spatial.py::serve_on``). A rank
replays by CUDA graph where its program has no collective (dim 0) or the
group is NCCL; a spatial program under gloo runs eagerly, with a note.
A weight saved on another card than the rank's is moved to it
(``torch.export.passes.move_to_device_pass``; a rank's card differs from
the export's only across cards).
"""

from __future__ import annotations

import argparse
import concurrent.futures as futures
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .data.labels import train_id_colors
from .data.transforms_host import load_image
from .ops.cuda import int8_conv as _int8_conv
from .ops.cuda import upsample_argmax as _upsample_argmax
from .parallel import spatial as _spatial
from .parallel.distributed import collective_device, spawn
from .utils.export import (artifact_shard_dim, export_numerics, is_bundle,
                           read_exported, read_exported_bundle,
                           read_exported_spatial, read_meta)

_EXTS = (".png", ".jpg", ".jpeg")
#: the kernel launch counters of the ops an artifact may hold (a row
#: window's launches, a spatial artifact's, count as upsample_argmax's)
_COUNTERS = {"upsample_argmax": _upsample_argmax, "int8_conv": _int8_conv}
#: printed where a spatial program runs eagerly
SPATIAL_EAGER_NOTE = (
    "a spatial artifact's exchanges run over gloo here and cannot be "
    "captured in a CUDA graph; serving eagerly (the labels are the same)")


def list_images(root: str) -> List[str]:
    out = []
    for dirpath, _dirs, files in os.walk(root):
        out.extend(os.path.join(dirpath, f) for f in files
                   if f.lower().endswith(_EXTS))
    return sorted(out)


def resolve_device(name: str) -> torch.device:
    """``--device``: ``cpu``, or a card that exists (never a fallback)."""
    try:
        device = torch.device(name)
    except RuntimeError:
        raise SystemExit(f"--device {name!r}: expected 'cpu' or 'cuda:<n>'"
                         ) from None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: CUDA is not available (pass "
                             f"--device cpu with a CPU artifact)")
        index = device.index or 0
        if index >= torch.cuda.device_count():
            raise SystemExit(f"--device {name}: only "
                             f"{torch.cuda.device_count()} CUDA device(s)")
        return torch.device("cuda", index)
    if device.type != "cpu":
        raise SystemExit(f"--device {name}: expected 'cpu' or 'cuda:<n>'")
    return device


def _launch_counts() -> Dict[str, int]:
    return {name: module.LAUNCHES for name, module in _COUNTERS.items()}


class Program:
    """One loaded program on ``device``. On a card (``capture``), each
    concrete batch size is warmed up once on a side stream (kernel
    builds, cuDNN plans), then captured into a CUDA graph over a static
    input slot; a call copies the frames into the slot and replays.
    ``replayed`` counts the kernel launches the replays enqueued (a
    replay passes through no wrapper, so its counter does not move),
    ``captured`` the wrapper calls that only recorded into a graph."""

    def __init__(self, module, device: torch.device, capture: bool = True):
        self.module = module
        self.device = device
        self.capture = capture and device.type == "cuda"
        self.graphs: Dict[int, tuple] = {}
        self.captured = {name: 0 for name in _COUNTERS}
        self.replayed = {name: 0 for name in _COUNTERS}

    def _capture(self, frames: torch.Tensor) -> tuple:
        slot = torch.empty(frames.shape, dtype=torch.uint8,
                           device=self.device)
        slot.copy_(frames)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.module(slot)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self.module(slot)
        after = _launch_counts()
        launches = {n: after[n] - before[n] for n in after}
        for name, n in launches.items():
            self.captured[name] += n
        return slot, out, graph, launches

    def __call__(self, frames: torch.Tensor,
                 to_host: bool = True) -> torch.Tensor:
        """uint8 (B, H, W, 3) frames -> int32 (B, H, W) labels, on the
        host (waiting for the device) or, ``to_host`` False, where the
        program put them."""
        with torch.inference_mode():
            if not self.capture:
                out = self.module(frames.to(self.device))
                return out.cpu() if to_host else out
            b = frames.shape[0]
            if b not in self.graphs:
                self.graphs[b] = self._capture(frames)
            slot, out, graph, launches = self.graphs[b]
            slot.copy_(frames, non_blocking=True)
            graph.replay()
            for name, n in launches.items():
                self.replayed[name] += n
            return out.cpu() if to_host else out.clone()


def _load_programs(artifact: str, meta: Dict, device: torch.device,
                   rank: int, capture: bool):
    """{batch: Program} of this rank: the global batch as the key (None
    for a symbolic batch)."""
    if is_bundle(artifact):
        loaded = read_exported_bundle(artifact)
    elif artifact_shard_dim(meta) == 1:
        loaded = {None: read_exported_spatial(artifact, rank)}
    else:
        exported = read_exported(artifact)
        loaded = {exported.meta["batch"]: exported}
    saved_on = {t.device for e in loaded.values()
                for t in e.program.state_dict.values()}
    if len(saved_on) == 1 and saved_on != {device} and (
            next(iter(saved_on)).type == device.type == "cuda"):
        # a rank on another card than the export's (across cards only)
        from torch.export.passes import move_to_device_pass

        loaded = {b: e._replace(program=move_to_device_pass(e.program,
                                                            device))
                  for b, e in loaded.items()}
        saved_on = {t.device for e in loaded.values()
                    for t in e.program.state_dict.values()}
    if saved_on != {device}:
        raise SystemExit(f"{artifact} holds its weights on "
                         f"{sorted(map(str, saved_on))}, and --device is "
                         f"{device}: serve it on that device")
    return {b: Program(e.program.module(), device, capture)
            for b, e in loaded.items()}


def _out_names(paths: List[str], images_dir: str, output_dir: str):
    """path, suffix -> the output file, its directory made."""
    # same-stem inputs differing only by extension (photo.jpg + photo.png)
    # would collide after the extension strip: those keep the extension
    stem_count: dict = {}
    for p in paths:
        s = os.path.splitext(os.path.relpath(p, images_dir))[0]
        stem_count[s] = stem_count.get(s, 0) + 1

    def out_name(path, suffix):
        # the subdirectories are kept: basename-only stems would overwrite
        # same-named files of different directories
        rel = os.path.relpath(path, images_dir)
        stem, ext = os.path.splitext(rel)
        if stem_count.get(stem, 0) > 1:
            stem = f"{stem}.{ext.lstrip('.')}"
        full = os.path.join(output_dir, f"{stem}{suffix}.png")
        os.makedirs(os.path.dirname(full), exist_ok=True)
        return full
    return out_name


def _serve(rank: int, world: int, device: torch.device, artifact: str,
           images_dir: str, output_dir: str, batch_size: int, color: bool,
           faithful_resize: bool) -> Optional[dict]:
    """The run on ``device``: one process, or one rank of a group serving
    a multi-device artifact (module docstring). Rank 0 returns the
    stats."""
    meta = read_meta(artifact)
    h, w = meta["height"], meta["width"]
    dim = artifact_shard_dim(meta)
    mesh = None
    capture = True
    if world > 1:
        if dim == 1:
            mesh = _spatial.SpatialMesh(1, world)
            _spatial.serve_on(mesh)
            capture = mesh.capturable
            if device.type == "cuda" and not capture and rank == 0:
                print(SPATIAL_EAGER_NOTE)
        where = collective_device()
    programs = _load_programs(artifact, meta, device, rank, capture)
    if is_bundle(artifact):
        # one concrete-batch program per size: the steady state runs the
        # largest size <= --batch_size, a ragged tail the smallest program
        # that fits it (JAX :48-56)
        fitting = [b for b in programs if b <= batch_size]
        batch_size = max(fitting) if fitting else min(programs)
    else:
        (fixed,) = programs
        if fixed is not None:
            batch_size = fixed
        elif dim == 0 and world > 1:
            # a symbolic N*b batch: round up to whole ranks (JAX :99-103)
            batch_size = -(-batch_size // world) * world
        programs = {batch_size: programs[fixed]}

    def program_for(n_frames):
        """(batch, program) for a chunk: the main one, or in a bundle the
        smallest baked batch that fits a ragged tail."""
        fit = min((b for b in programs if b >= n_frames), default=batch_size)
        return fit, programs[fit]

    paths = list_images(images_dir) if rank == 0 else []
    chunks = [paths[s:s + batch_size]
              for s in range(0, len(paths), batch_size)]
    if world > 1:
        # every rank runs one program call a chunk, at the chunk's batch
        plan = [[program_for(len(c))[0] for c in chunks]]
        dist.broadcast_object_list(plan, src=0)
        if rank > 0:
            # this rank's program on each chunk's shard, as rank 0 plans
            with export_numerics(meta):
                for target in plan[0]:
                    _scatter_run_gather(programs[target], None, target,
                                        (h, w), dim, world, where)
            return None
    os.makedirs(output_dir, exist_ok=True)
    from PIL import Image

    # predictions are in [0, 19): only the train-id colours are used
    palette = train_id_colors() if color else None
    decode_seconds = [0.0]
    served_by: Dict[int, int] = {}     # chunks by the batch that ran them

    def decode_chunk(chunk):
        t0 = time.perf_counter()
        frames = np.stack([load_image(p, (h, w), faithful_resize)
                           for p in chunk])
        target, program = program_for(len(chunk))
        served_by[target] = served_by.get(target, 0) + 1
        if len(chunk) < target:
            # pad every ragged tail: on a card each batch size is a graph
            # of its own, on the CPU a program of its own shape
            pad = np.zeros((target - len(chunk), *frames.shape[1:]),
                           np.uint8)
            frames = np.concatenate([frames, pad])
        frames = torch.from_numpy(frames)
        if device.type == "cuda" and world == 1:
            frames = frames.pin_memory()
        decode_seconds[0] += time.perf_counter() - t0
        return frames, program

    out_name = _out_names(paths, images_dir, output_dir)
    before = _launch_counts()
    n_done, t0, t_first = 0, time.perf_counter(), 0.0
    with export_numerics(meta), futures.ThreadPoolExecutor(
            max_workers=1) as pool:
        # one-chunk decode lookahead: the host decodes chunk k+1 while the
        # device runs chunk k
        pending = pool.submit(decode_chunk, chunks[0])
        for i, chunk in enumerate(chunks):
            frames, program = pending.result()
            if i + 1 < len(chunks):
                pending = pool.submit(decode_chunk, chunks[i + 1])
            if world > 1:
                preds = _scatter_run_gather(program, frames,
                                            frames.shape[0], (h, w), dim,
                                            world, where)
            else:
                preds = program(frames)
            preds = preds[:len(chunk)].numpy()
            if i == 0:
                t_first = time.perf_counter() - t0
            for path, pred in zip(chunk, preds):
                Image.fromarray(pred.astype(np.uint8), mode="L").save(
                    out_name(path, "_trainIds"))
                if palette is not None:
                    Image.fromarray(palette[pred]).save(
                        out_name(path, "_color"))
            n_done += len(chunk)
    dt = time.perf_counter() - t0
    after = _launch_counts()
    launches = {name: after[name] - before[name]
                + sum(p.replayed[name] - p.captured[name]
                      for p in programs.values()) for name in after}
    # the first batch absorbs the kernels' builds and the graph's capture,
    # so it is reported apart from the steady rate of the others
    steady = n_done - len(chunks[0])
    rate: Optional[float] = (steady / (dt - t_first)
                             if steady and dt > t_first else None)
    ranks = (f" x {world} ranks ({dist.get_backend()}, shard dim {dim})"
             if world > 1 else "")
    print(f"served {n_done} images in {dt:.2f}s on {device}{ranks} (first "
          f"batch {t_first:.2f}s, builds and captures included"
          + (f", then {rate:.1f} img/s steady-state" if rate else "")
          + f"; decode {decode_seconds[0] / n_done * 1e3:.1f} ms an image; "
          f"kernel launches {launches}" + (" on rank 0)" if ranks else ")"))
    return {"images": n_done, "seconds": dt, "first_batch_seconds": t_first,
            "steady_images_per_s": rate,
            "decode_ms_per_image": decode_seconds[0] / n_done * 1e3,
            "batch_size": batch_size, "chunks_by_batch": served_by,
            "launches": launches, "ranks": world, "shard_dim": dim,
            "exchanges": mesh.exchanges if mesh is not None else 0}


def _scatter_run_gather(program: Program, frames: Optional[torch.Tensor],
                        target: int, hw, dim: int, world: int,
                        where: torch.device) -> Optional[torch.Tensor]:
    """One chunk of ``target`` frames of ``hw`` over the ranks: rank 0's
    ``frames`` scattered on ``dim`` (over the collective device
    ``where``), this rank's program on its shard, the labels gathered on
    rank 0 (the host tensor there, None elsewhere)."""
    rank = dist.get_rank()
    h, w = hw
    shape = ((target // world, h, w, 3) if dim == 0
             else (target, h // world, w, 3))
    mine = torch.empty(shape, dtype=torch.uint8, device=where)
    shards = ([t.contiguous().to(where) for t in frames.chunk(world, dim)]
              if rank == 0 else None)
    dist.scatter(mine, shards, src=0)
    labels = program(mine, to_host=False).to(where).contiguous()
    got = ([torch.empty_like(labels) for _ in range(world)]
           if rank == 0 else None)
    dist.gather(labels, got, dst=0)
    return torch.cat(got, dim).cpu() if rank == 0 else None


def _check_devices(artifact: str, spec: str,
                   meta: Dict) -> List[torch.device]:
    """``--device``'s list for an artifact of ``nr_devices`` N: at least N
    (JAX's message), the first N used; every one of the artifact's
    device type."""
    devices = [resolve_device(name.strip()) for name in spec.split(",")]
    n = meta.get("nr_devices", 1)
    if len(devices) < n:
        raise SystemExit(f"pod artifact needs {n} devices, this host "
                         f"presents {len(devices)}")
    devices = devices[:n]
    for device in devices:
        if meta["device"] != device.type:
            raise SystemExit(
                f"{artifact} was exported for {meta['device']}, and "
                f"--device is {device}: an artifact runs on the device "
                f"type it was exported on (export it again on "
                f"{device.type})")
    return devices


def run(artifact: str, images_dir: str, output_dir: str,
        batch_size: int = 8, color: bool = False,
        faithful_resize: bool = False, device: str = "cuda:0") -> dict:
    meta = read_meta(artifact)
    devices = _check_devices(artifact, device, meta)
    if not meta["preprocess"]:
        raise SystemExit("the artifact must take uint8 NHWC images "
                         "(export_inference preprocess=True)")
    if not list_images(images_dir):
        raise SystemExit(f"no images under {images_dir}")
    args = (artifact, images_dir, output_dir, batch_size, color,
            faithful_resize)
    if len(devices) == 1:
        return _serve(0, 1, devices[0], *args)
    # one card named twice: ranks sharing it go through gloo (NCCL refuses
    # two ranks on one card)
    shared = len(set(devices)) < len(devices) or devices[0].type == "cpu"
    return spawn(_serve, devices, *args,
                 backend="gloo" if shared else "nccl")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="run an exported serving artifact over a directory")
    p.add_argument("artifact", help="path from --export_model / "
                                    "utils.export.export_inference")
    p.add_argument("--images", required=True, help="directory of images")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--color", action="store_true",
                   help="also write palette-colorized predictions")
    p.add_argument("--faithful_resize", action="store_true",
                   help="reproduce the reference's transposed PIL resize "
                        "(cityscapes.py:22; only valid for square inputs "
                        "at serving time)")
    p.add_argument("--device", default="cuda:0",
                   help="'cuda:<n>' (default cuda:0) or 'cpu'; the "
                        "artifact's own device type, never a fallback; "
                        "a comma list of N for an artifact of N ranks "
                        "(one card named twice: two ranks share it)")
    args = p.parse_args(argv)
    return run(args.artifact, args.images, args.output,
               batch_size=args.batch_size, color=args.color,
               faithful_resize=args.faithful_resize, device=args.device)


def console_main() -> int:
    """The target for a console entry point (as JAX ``serve.py``'s
    ``dseg-serve``): ``main`` returns a stats dict, which setuptools would
    misread as a nonzero exit status."""
    main()
    return 0


if __name__ == "__main__":
    main()
