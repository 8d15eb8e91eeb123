"""Process groups: the ranks of a data-parallel run and their collectives.

Counterpart of ``dasemanticsegmentationaml_tpu/parallel/distributed.py``
(:34-139). Where JAX joins processes with ``jax.distributed.initialize``
and lays a device mesh over them, the port runs one rank of a
``torch.distributed`` process group per device: NCCL between cards, gloo
on the CPU (or, for a library caller, between ranks that share a card:
NCCL refuses two ranks on one device).

* ``initialize`` joins the group from the flags (``--coordinator_address``,
  ``--num_processes``, ``--process_id``) or from torchrun's environment
  (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), the
  counterpart of the ``JAX_*`` variables JAX :50-55 reads; with one
  process it does nothing.
* ``allreduce_counts`` sums eval's int64 counts exactly. JAX :102-126
  carries float64 counts through fp32 halves because its all-gather runs
  in fp32; torch reduces int64 as it is.
* JAX's ``global_batch_arrays`` (:77-97) has no counterpart: it assembles
  one global array from each process's slice, where here each rank keeps
  its slice and the collectives of the step (``parallel/mesh.py``) join
  them.

A failed initialisation or collective raises; nothing retries on another
backend or drops to fewer ranks.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

#: how long ``init_process_group`` waits for every rank, and how long a
#: collective may wait for the others before it raises
TIMEOUT = datetime.timedelta(minutes=30)


def init_method(coordinator_address: str) -> str:
    """``host:port`` (JAX's form) -> ``tcp://host:port``; a URL
    (``tcp://``, ``file://``, ``env://``) is taken as it is."""
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: Optional[torch.device] = None) -> bool:
    """Join the default process group as rank ``process_id`` of
    ``num_processes`` (JAX :34-62); returns whether a group of more than
    one rank was joined. Missing arguments come from torchrun's
    environment; with neither, or one process, it does nothing.
    ``backend``: NCCL for a CUDA ``device``, gloo otherwise, unless given
    (``"gloo"`` lets two ranks share one card). Already initialised: a
    no-op."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = "env://"
    if not num_processes or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise SystemExit(
            f"--num_processes {num_processes} needs --coordinator_address "
            f"and --process_id (or torchrun's MASTER_ADDR and RANK)")
    if not 0 <= process_id < num_processes:
        raise SystemExit(f"--process_id {process_id} is not a rank of "
                         f"{num_processes} processes")
    if backend is None:
        cuda = device is not None and torch.device(device).type == "cuda"
        backend = "nccl" if cuda else "gloo"
    kwargs = {}
    if backend == "nccl" and device is not None:
        # binds the communicator to this rank's card at once
        kwargs["device_id"] = torch.device(device)
    dist.init_process_group(backend, init_method=init_method(
        coordinator_address), world_size=num_processes, rank=process_id,
        timeout=TIMEOUT, **kwargs)
    return True


class _QueueReport:
    """A spawned rank 0's ``report_fn``: each ``report_fn(*values)`` goes to
    the parent as ``("report", values)`` on the result queue, where
    ``spawn`` hands it to the caller's ``report_fn`` (it pickles where the
    caller's may not: a lambda, a reporter holding a module)."""

    def __init__(self, results):
        self.results = results

    def __call__(self, *values):
        self.results.put(("report", values))


def _spawned(fn, rank: int, world: int, device: str, init: str,
             backend: Optional[str], results, args, reports: bool) -> None:
    """One rank of ``spawn`` (a spawned process): join the group, run
    ``fn``, and hand rank 0's result to the parent; with ``reports``,
    ``fn`` takes ``report_fn=``: rank 0's puts each report on the queue
    ahead of the result, the others' is None."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize(init, world, rank, backend=backend, device=device)
    kwargs = ({"report_fn": _QueueReport(results) if rank == 0 else None}
              if reports else {})
    try:
        result = fn(rank, world, device, *args, **kwargs)
    finally:
        destroy()
    if rank == 0:
        results.put(("result", result))


def spawn(fn, devices, *args, backend: Optional[str] = None,
          report_fn: Optional[Callable] = None):
    """``fn(rank, world, device, *args)`` in one spawned process a device
    of ``devices``, the processes one group (``backend``: by
    ``initialize``'s rule where None) meeting through a file store in a
    fresh temporary directory; returns rank 0's result. A rank that exits
    with an error ends the others and stops the run. ``fn`` must be
    importable (a spawned rank re-imports its module and the caller's
    ``__main__``).

    ``report_fn``: ``fn`` is called with ``report_fn=`` too, on rank 0 a
    callable that sends its arguments to this process, where
    ``report_fn`` is called with them, in order, as they arrive (the queue
    is read every 0.2 s), so once each and live; on the other ranks None.
    ``report_fn`` itself stays in this process and need not pickle."""
    import multiprocessing
    import shutil
    import tempfile
    import time

    ctx = multiprocessing.get_context("spawn")
    store = tempfile.mkdtemp(prefix="dseg-ranks-")
    results = ctx.SimpleQueue()
    procs = [ctx.Process(target=_spawned, name=f"rank-{r}",
                         args=(fn, r, len(devices), str(dev),
                               "file://" + os.path.join(store, "store"),
                               backend, results, args,
                               report_fn is not None))
             for r, dev in enumerate(devices)]
    done = []

    def take(message):
        kind, value = message
        if kind == "report":
            report_fn(*value)
        else:
            done.append(value)

    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            # drained while rank 0 lives, so that its puts never wait
            while not done and not results.empty():
                take(results.get())
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed:
                raise SystemExit(f"{failed[0].name} exited with code "
                                 f"{failed[0].exitcode}; the other ranks "
                                 f"were stopped")
            time.sleep(0.2)
        failed = [p for p in procs if p.exitcode != 0]
        if failed:
            raise SystemExit(f"{failed[0].name} exited with code "
                             f"{failed[0].exitcode}")
        while not done:
            take(results.get())
        return done[0]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        shutil.rmtree(store, ignore_errors=True)


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_rank(group=None) -> Tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group (JAX :69)."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def is_multiprocess(group=None) -> bool:
    return process_rank(group)[1] > 1


def local_batch_size(global_batch_size: int, world: Optional[int] = None
                     ) -> int:
    """Each rank's share of a global batch, contiguous in rank order
    (JAX :73-80)."""
    n = process_rank()[1] if world is None else world
    if global_batch_size % n:
        raise SystemExit(
            f"--batch_size {global_batch_size} must be divisible by the "
            f"process count {n} (each process loads batch/processes "
            "samples)")
    return global_batch_size // n


def collective_device(group=None) -> torch.device:
    """Where a collective's tensors must live: the rank's card under NCCL,
    the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allreduce_counts(hist: torch.Tensor, correct: torch.Tensor, total: int,
                     group=None):
    """The exact sum over the ranks of eval's counts (JAX :102-126): the
    int64 confusion matrix, the int64 correct-pixel count and the pixel
    count, in one int64 ``all_reduce``; the results on ``hist``'s
    device. Outside a process group they come back as they are."""
    if not dist.is_initialized():
        return hist, correct, total
    flat = torch.cat([hist.reshape(-1).to(torch.int64),
                      correct.reshape(1).to(torch.int64),
                      torch.tensor([total], dtype=torch.int64,
                                   device=hist.device)])
    on = flat.to(collective_device(group))
    dist.all_reduce(on, group=group)
    flat = on.to(hist.device)
    n = hist.numel()
    return (flat[:n].reshape(hist.shape), flat[n], int(flat[n + 1].item()))


def assert_same_across_processes(value: float, what: str, tol: float = 0.0,
                                 group=None) -> None:
    """Every rank must hold ``value`` within ``tol`` (JAX :129-138): one
    ``all_gather`` of a float64."""
    if not is_multiprocess(group):
        return
    device = collective_device(group)
    mine = torch.tensor([float(value)], dtype=torch.float64, device=device)
    gathered = [torch.empty_like(mine)
                for _ in range(dist.get_world_size(group))]
    dist.all_gather(gathered, mine, group=group)
    values = torch.cat(gathered).cpu()
    if not bool(((values - values[0]).abs() <= tol).all()):
        raise AssertionError(
            f"{what} diverged across processes: {values.tolist()!r}")


def barrier(group=None) -> None:
    """Wait for every rank; no-op outside a process group. Under NCCL on
    the rank's card, so that it names the device."""
    if not is_multiprocess(group):
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)
