"""Optimizers with the reference's PyTorch update rules.

Counterpart of ``dasemanticsegmentationaml_tpu/train/optim.py``
(``make_optimizer`` :29-73, ``set_learning_rate`` :91-102), whose optax
chains rebuild exactly these ``torch.optim`` rules (reference
train.py:501-509):

* ``sgd``: ``torch.optim.SGD`` -- weight decay added to the gradient
  before momentum (not decoupled), ``buf = momentum * buf + g`` starting
  from the first gradient.
* ``adam``: ``torch.optim.Adam`` -- bias-corrected, eps outside the sqrt
  (optax ``eps_root=0``).
* ``rmsprop``: ``torch.optim.RMSprop`` -- ``alpha=0.99``, eps outside the
  sqrt (optax ``eps_in_sqrt=False``).

The JAX package masks the backbone's ImageNet head out of the update
(``models/bisenet.py::unused_param_mask``); here the optimizer is simply
given the trainable parameters (``models/bisenet.py::
trainable_parameters``). The LR is set once per epoch from the host with
``set_learning_rate``. The JAX ``group_weight_mask`` (decay split) is on
no path yet.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   learning_rate: float, momentum: float = 0.9,
                   weight_decay: float = 0.0, betas=(0.9, 0.999),
                   eps: float = 1e-8) -> torch.optim.Optimizer:
    """``sgd`` | ``adam`` | ``rmsprop`` over ``params``; weight decay is
    applied by SGD only, as in the JAX chains."""
    name = name.lower()
    params = list(params)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                               weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=tuple(betas),
                                eps=eps)
    if name == "rmsprop":
        return torch.optim.RMSprop(params, lr=learning_rate, alpha=0.99,
                                   eps=eps)
    raise ValueError(f"unsupported optimizer {name!r} (rmsprop|sgd|adam, "
                     "reference train.py:501-509)")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
