"""Checkpoints: reference-named weights (``.pth``) and the full train state
behind ``--resume``.

Counterpart of ``dasemanticsegmentationaml_tpu/cli.py::make_checkpoint_fn``
(:87-125). Each call writes:

* ``<dir>/<name>.pth``: the weights, reference-named (reference
  train.py:106-117 saves ``model.module.state_dict()``; train.py:280-283's
  DA checkpoints keep DataParallel's ``module.`` prefix). The port's
  modules carry the reference's names, so the state dict without
  ``num_batches_tracked`` is the 216 tensors the JAX package writes
  (``torch_io.variables_to_torch_state``): the file loads into the JAX
  package through ``torch_io.load_pretrained`` and into the port through
  ``utils/weights.py::load_pretrain``.
* ``<dir>/state/<name>.pt``: the full train state (``utils/state_io.py``),
  the module's state dict with ``num_batches_tracked``, the optimizer's
  state dict, the gradient accumulator's (``--iter_size``) and the epoch;
  and the same file under the alias ``latest`` (``latest_D1`` for
  ``model="discriminator"``; a hard link) whenever ``name`` is not the
  alias, so that ``--resume <dir>/state`` needs no knowledge of the DA
  names (``GTA5_<step>[_D1]``). As in JAX, a ``best`` save moves
  ``latest`` too.
* ``<dir>/state/EPOCH``, when ``epoch`` is given, after the states: a run
  that dies between the two resumes the newer state at the older epoch,
  as the JAX package's does.

In a data-parallel run (a process group of more than one rank) every
rank calls the function and only rank 0 writes, then every rank waits at a
barrier, so that none reads a half-written file (JAX cli.py:98-123 writes
the ``.pth`` and the marker from process 0). Rank 0's module is the one
saved: in the per-replica BN mode its statistics are shard 0's, as JAX's
``untile_state`` exports them.

The JAX package keeps its state as orbax trees under ``<dir>/orbax/``;
neither side resumes the other's state, and both read each other's
``.pth``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..parallel.distributed import barrier, process_rank
from . import state_io


def reference_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's reference-named tensors, on the CPU."""
    return {k: v.detach().to("cpu", copy=True).contiguous()
            for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def train_state(module: nn.Module, optimizer: torch.optim.Optimizer,
                accumulator=None, epoch: Optional[int] = None) -> dict:
    """What ``--resume`` restores, on the CPU."""
    return state_io.to_host({
        "model": module.state_dict(),
        "optimizer": optimizer.state_dict(),
        "accumulator": (None if accumulator is None
                        else accumulator.state_dict()),
        "epoch": epoch,
    })


def make_checkpoint_fn(save_model_path=None):
    """checkpoint_fn(module, name, dataparallel_prefix=False, *, optimizer,
    accumulator=None, model=None, epoch=None) writes ``<dir>/<name>.pth``
    and the full state under ``<dir>/state/``, the directory being
    ``save_model_path`` or ``./checkpoints``; ``dataparallel_prefix``
    prefixes every ``.pth`` key with ``module.`` (JAX cli.py:112-114);
    ``model="discriminator"`` picks the alias ``latest_D1``."""
    save_dir = save_model_path or "./checkpoints"
    state_dir = os.path.join(save_dir, "state")

    def checkpoint_fn(module: nn.Module, name: str,
                      dataparallel_prefix: bool = False, *,
                      optimizer: torch.optim.Optimizer, accumulator=None,
                      model: Optional[str] = None,
                      epoch: Optional[int] = None) -> str:
        path = os.path.join(save_dir, f"{name}.pth")
        if process_rank()[0] == 0:
            os.makedirs(save_dir, exist_ok=True)
            weights = reference_state(module)
            if dataparallel_prefix:
                weights = {f"module.{k}": v for k, v in weights.items()}
            torch.save(weights, path)
            state_io.save_train_state(
                state_dir, name, train_state(module, optimizer, accumulator,
                                             epoch))
            alias = "latest_D1" if model == "discriminator" else "latest"
            if name != alias:
                state_io.link_train_state(state_dir, name, alias)
            if epoch is not None:
                state_io.write_epoch_marker(state_dir, epoch)
        barrier()
        return path

    return checkpoint_fn
