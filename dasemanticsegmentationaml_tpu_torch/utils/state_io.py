"""Full train state on disk, for ``--resume``.

Counterpart of ``dasemanticsegmentationaml_tpu/utils/orbax_io.py``
(``save_train_state`` :24, ``restore_train_state`` :34,
``latest_epoch_marker`` :45, ``write_epoch_marker`` :56), without orbax:
one ``torch.save`` file per name, ``<dir>/<name>.pt``, beside an
``EPOCH`` marker. What a state holds is the caller's
(``utils/checkpoint.py``): the module's state dict, the optimizer's, the
gradient accumulator's and the epoch.

Every write is atomic: the file is written under a temporary name and
moved over the old one with ``os.replace``, so a run that dies mid-write
leaves the previous state (or none), never half of one. An alias is a
hard link to the state it names (``link_train_state``). The port's state
and the JAX package's orbax trees do not read each other; the ``.pth``
weights are shared.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch


def state_path(directory: str, name: str) -> str:
    return os.path.join(directory, f"{name}.pt")


def to_host(obj: Any) -> Any:
    """``obj`` with every tensor on the CPU (CPU tensors as they are), so
    that a save's copy from the card and its write can be told apart."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu")
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def save_train_state(directory: str, name: str, state: Any) -> str:
    """Write ``state`` (tensors anywhere; saved from the CPU) as
    ``<directory>/<name>.pt``; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = state_path(directory, name)
    tmp = os.path.join(directory, f".{name}.pt.tmp.{os.getpid()}")
    torch.save(to_host(state), tmp)
    os.replace(tmp, path)
    return path


def link_train_state(directory: str, name: str, alias: str) -> str:
    """Make ``<directory>/<alias>.pt`` the file ``<name>.pt`` is, by a hard
    link moved into place with ``os.replace`` (a copy where the file
    system has no hard links): the alias costs no second write, and a
    later save of either name replaces only that name. Returns the
    alias's path."""
    path = state_path(directory, alias)
    tmp = os.path.join(directory, f".{alias}.pt.tmp.{os.getpid()}")
    if os.path.lexists(tmp):
        os.remove(tmp)
    try:
        os.link(state_path(directory, name), tmp)
    except OSError:
        shutil.copyfile(state_path(directory, name), tmp)
    os.replace(tmp, path)
    return path


def restore_train_state(directory: str, name: str,
                        map_location: Optional[str] = "cpu") -> Any:
    """Read ``<directory>/<name>.pt`` with ``weights_only=True``.

    The tensors land on the CPU by default: ``load_state_dict`` of a
    module or an optimizer copies them to the parameters' device, and
    Adam's ``step`` counters stay on the host, as a fresh Adam keeps them
    (a ``step`` on the card would make every Adam step read it back)."""
    return torch.load(state_path(directory, name), weights_only=True,
                      map_location=map_location)


def latest_epoch_marker(directory: str) -> Optional[int]:
    """The epoch of the last checkpoint written beside the states, or None
    when no marker is there."""
    marker = os.path.join(directory, "EPOCH")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return int(f.read().strip())


def write_epoch_marker(directory: str, epoch: int) -> None:
    """Atomically (tmp, fsync, ``os.replace``): an interrupted
    open-truncate-write would leave an empty marker, and the next
    ``--resume`` would die in ``int('')``."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".EPOCH.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(str(epoch))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, "EPOCH"))
