"""The numbers that decide ``correct``: the program against the reference.

Training (``training_numbers``): the program's first steps, taken by the
timed path in set-up, against the reference's steps from the same state
dict on the same batches. The contract's numbers:

* ``loss``: the largest relative gap of a step's loss, ``|program -
  reference| / |reference|``, over the steps and the loss terms
  (``loss_first``: the first step's alone);
* ``grad``: the first step's gradient as the optimizer holds it after one
  step (SGD's momentum buffer, less the weight decay of the initial
  weights), by the worst leaf: ``|norm(program) - norm(reference)|``
  over the larger of the reference leaf's norm and the median leaf's
  (``grad_median``: the median leaf's; ``grad_global``: all leaves as
  one);
* ``change``: the parameters' change over the steps, as ``grad``, leaving
  out the leaves whose reference first gradient is under a thousandth of
  the median leaf's (their change is round-off) (``change_median``,
  ``change_global``).

At this random initial state bf16 rounding scatters the per-leaf
gradients of both sides, so these read alike for sound runs and for the
control (PERF.md, Findings). What separates them, by the norm of the
difference over the reference's norm, on G's three classifier convs next
to the loss: ``head_grad``, their first gradient, and ``head_change``,
their change over the steps, which the optimizer's update (its learning
rate, momentum and decay) shapes. A cell compares the numbers its
``limits/<cell>.json`` names.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence

import torch

#: leaves whose reference gradient is under this share of the median
#: leaf's are left out of ``change``
DEAD_GRAD = 1e-3
#: G's classifier convs (the 1x1 ``conv_out`` of each of the three heads)
HEAD_LEAF = "conv_out.weight"


def _norms(tensors: Sequence[torch.Tensor]) -> List[float]:
    return [float(t.double().norm()) for t in tensors]


def leaf_gaps(program: Sequence[torch.Tensor], reference: Sequence[torch.Tensor],
              keep: Optional[Sequence[bool]] = None) -> List[float]:
    """Each kept leaf's gap of norms (module docstring)."""
    p, r = _norms(program), _norms(reference)
    keep = keep if keep is not None else [True] * len(r)
    kept = [i for i in range(len(r)) if keep[i]]
    median = statistics.median(r[i] for i in kept)
    return [abs(p[i] - r[i]) / max(r[i], median, 1e-30) for i in kept]


def global_gap(program: Sequence[torch.Tensor],
               reference: Sequence[torch.Tensor]) -> float:
    """The gap of the norms of all leaves together, over the reference's."""
    p = math.sqrt(sum(n * n for n in _norms(program)))
    r = math.sqrt(sum(n * n for n in _norms(reference)))
    return abs(p - r) / max(r, 1e-30)


def relative_difference(program: Sequence[torch.Tensor],
                        reference: Sequence[torch.Tensor]) -> float:
    """``norm(program - reference) / norm(reference)`` over the leaves
    together."""
    diff = math.sqrt(sum(float((p.double() - r.double()).norm()) ** 2
                         for p, r in zip(program, reference)))
    ref = math.sqrt(sum(n * n for n in _norms(reference)))
    return diff / max(ref, 1e-30)


def loss_gap(program: Sequence[Sequence[float]],
             reference: Sequence[Sequence[float]]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30)
               for ps, rs in zip(program, reference) for p, r in zip(ps, rs))


def training_numbers(program: dict, reference: dict, initial: Sequence[torch.Tensor],
                     grad_of_opt1=None, names: Sequence[str] = ()
                     ) -> Dict[str, float]:
    """``program`` and ``reference``: {"losses", "opt1", "params"} with the
    leaves in one order (``reference/steps.py``); ``initial``: the leaves
    before the first step; ``grad_of_opt1(opt1, initial)`` -> the first
    gradient's leaves (None: the state as it is); ``names``: the leaves'
    names, which pick G's classifier convs."""
    def first_grads(side):
        state = [t for s in side["opt1"] for t in s.values()]
        return grad_of_opt1(state, initial) if grad_of_opt1 else state

    g_prog, g_ref = first_grads(program), first_grads(reference)
    ref_norms = _norms(g_ref)
    median = statistics.median(ref_norms)
    moved = [n >= DEAD_GRAD * median for n in ref_norms]
    c_prog = [p.double() - i.double() for p, i in zip(program["params"], initial)]
    c_ref = [p.double() - i.double() for p, i in zip(reference["params"], initial)]
    changes = leaf_gaps(c_prog, c_ref, keep=moved)
    grads = leaf_gaps(g_prog, g_ref)
    numbers = {"loss": loss_gap(program["losses"], reference["losses"]),
               "loss_first": loss_gap(program["losses"][:1],
                                      reference["losses"][:1]),
               "grad": max(grads), "grad_median": statistics.median(grads),
               "grad_global": global_gap(g_prog, g_ref),
               "change": max(changes),
               "change_median": statistics.median(changes),
               "change_global": global_gap(c_prog, c_ref)}

    heads = [i for i, n in enumerate(names) if n.endswith(HEAD_LEAF)]
    if heads:
        for key, sides in (("head_grad", (g_prog, g_ref)),
                           ("head_change", (c_prog, c_ref))):
            numbers[key] = relative_difference(*([s[i] for i in heads]
                                                 for s in sides))
    return numbers


def sgd_first_grad(weight_decay: float):
    """SGD's momentum buffer after one step is the gradient plus the
    weight decay of the initial weights."""
    def grad(state, initial):
        return [b.double() - weight_decay * p.double()
                for b, p in zip(state, initial)]
    return grad
