"""``latest.pth`` / ``best.pth`` / ``GTA5_<step>[_D1].pth``: weights,
reference-named.

Counterpart of the ``.pth`` half of ``dasemanticsegmentationaml_tpu/
cli.py::make_checkpoint_fn`` (:87-125; reference train.py:106-117, which
saves ``model.module.state_dict()``, and train.py:280-283, whose DA
checkpoints keep DataParallel's ``module.`` prefix). The port's modules
carry the
reference's names, so the state dict without ``num_batches_tracked`` is
the 216 tensors the JAX package writes (``torch_io.
variables_to_torch_state``): the file loads into the JAX package through
``torch_io.load_pretrained`` and into the port through
``utils/weights.py::load_pretrain``. The JAX package's orbax full state,
its EPOCH marker, ``latest_D1`` and ``--resume`` are still to be ported
(ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Dict

import torch
import torch.nn as nn


def reference_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's reference-named tensors, on the CPU."""
    return {k: v.detach().to("cpu", copy=True).contiguous()
            for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def make_checkpoint_fn(save_model_path=None):
    """checkpoint_fn(model, name, dataparallel_prefix=False) writes
    ``<dir>/<name>.pth``, the directory being ``save_model_path`` or
    ``./checkpoints``; ``dataparallel_prefix`` prefixes every key with
    ``module.`` (JAX cli.py:112-114)."""
    save_dir = save_model_path or "./checkpoints"

    def checkpoint_fn(model: nn.Module, name: str,
                      dataparallel_prefix: bool = False) -> str:
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, f"{name}.pth")
        state = reference_state(model)
        if dataparallel_prefix:
            state = {f"module.{k}": v for k, v in state.items()}
        torch.save(state, path)
        return path

    return checkpoint_fn
