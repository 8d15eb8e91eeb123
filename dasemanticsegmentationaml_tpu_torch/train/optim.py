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

``GradientAccumulator`` is ``--iter_size``: the counterpart of
``optax.MultiSteps(opt, every_k_schedule=iter_size)`` as JAX cli.py:719-722
wraps the supervised optimizer.
"""

from __future__ import annotations

from typing import Iterable, List

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


class GradientAccumulator:
    """Gradient accumulation over ``every_k`` mini-steps, as optax 0.2.6's
    ``MultiSteps.update`` does it (``use_grad_mean=True``):

    * the accumulator is a running mean, updated after each mini-step's
      backward as ``acc + (g - acc) / (n + 1)`` (optax's Welford form;
      ``n`` is the mini-step, 0 first), not a sum divided at the end,
      which rounds otherwise;
    * the inner optimizer steps only at mini-step ``every_k - 1``, on the
      mean, so its weight decay and momentum see the mean as the inner
      optax chain does, at the learning rate set for the epoch in which
      that mini-step falls; the mean is then zeroed;
    * a parameter without a gradient counts as a zero gradient (optax
      sees zeros where torch leaves ``grad`` None).

    Between emits the parameters do not move; BN running statistics move
    on every mini-step's forward. The accumulation carries across epochs
    and is part of the saved train state (``state_dict``), so a resumed
    run continues it; a partial accumulation at the end of training is
    dropped, as in JAX.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.optimizer = optimizer
        self.every_k = every_k
        self.params: List[torch.Tensor] = [
            p for group in optimizer.param_groups for p in group["params"]]
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0

    @torch.no_grad()
    def step(self) -> bool:
        """Fold this mini-step's gradients into the mean; at the k-th,
        step the optimizer on it. Returns whether the optimizer stepped."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        if self.mini_step < self.every_k - 1:
            self.mini_step += 1
            return False
        for p, acc in zip(self.params, self.acc):
            p.grad = acc
        self.optimizer.step()
        for p in self.params:
            p.grad = None
        torch._foreach_zero_(self.acc)
        self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        return {"every_k": self.every_k, "mini_step": self.mini_step,
                "acc": list(self.acc)}

    def load_state_dict(self, state: dict) -> None:
        if state["every_k"] != self.every_k:
            raise ValueError(
                f"the saved accumulation is over {state['every_k']} "
                f"mini-steps, this run's over {self.every_k} (--iter_size)")
        self.mini_step = int(state["mini_step"])
        for acc, saved in zip(self.acc, state["acc"], strict=True):
            acc.copy_(saved)
