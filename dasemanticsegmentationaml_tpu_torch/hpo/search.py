"""Search space + tuner: the port's own copy of JAX ``hpo/search.py``
(SEARCH_SPACE :24-31, ``_to_unit`` :35, ``_from_unit`` :44,
``sample_space`` :58, ``AnnealTuner`` :62), line for line, so that one
seed and one sequence of results draw the same parameters on both sides.

The space reproduces reference experiment_nni.py:107-114:

  batch_size    randint   [2, 12]
  lr            loguniform[1e-4, 0.1]
  lr_D1         loguniform[1e-6, 1e-3]
  num_epochs    randint   [15, 50]
  lambda_adv1   uniform   [1e-5, 1e-3]
  weight_decay  uniform   [1e-5, 0.01]

maximizing mIoU with NNI's Anneal tuner (experiment_nni.py:124-127). When
nni is unavailable we provide ``AnnealTuner``: simulated annealing in the
normalized unit cube -- start from random samples, then perturb the best
observed point with a temperature that decays per trial (the same family of
strategy as NNI's Anneal).
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

SEARCH_SPACE = {
    "batch_size": {"_type": "randint", "_value": [2, 12]},
    "lr": {"_type": "loguniform", "_value": [1e-4, 0.1]},
    "lr_D1": {"_type": "loguniform", "_value": [1e-6, 1e-3]},
    "num_epochs": {"_type": "randint", "_value": [15, 50]},
    "lambda_adv1": {"_type": "uniform", "_value": [1e-5, 1e-3]},
    "weight_decay": {"_type": "uniform", "_value": [1e-5, 0.01]},
}


def _to_unit(name: str, value: float) -> float:
    spec = SEARCH_SPACE[name]
    lo, hi = spec["_value"]
    if spec["_type"] == "loguniform":
        return (math.log(value) - math.log(lo)) / (math.log(hi) -
                                                   math.log(lo))
    return (value - lo) / (hi - lo)


def _from_unit(name: str, u: float):
    spec = SEARCH_SPACE[name]
    lo, hi = spec["_value"]
    u = min(max(u, 0.0), 1.0)
    if spec["_type"] == "loguniform":
        v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        # exp(log(hi)) can land 1 ulp above hi; keep the bound honest
        return min(max(v, lo), hi)
    v = lo + u * (hi - lo)
    if spec["_type"] == "randint":
        return int(min(max(round(v), lo), hi - 1))
    return v


def sample_space(rng: random.Random) -> Dict:
    return {name: _from_unit(name, rng.random()) for name in SEARCH_SPACE}


class AnnealTuner:
    """Maximizing annealing tuner over the unit cube, NNI/hyperopt-Anneal
    style: a random exploration phase, then Gaussian perturbations of the
    best observed point with a width that shrinks per exploit step, plus a
    small standing exploration probability. Defaults were tuned against
    matched-budget random search on a deterministic toy objective
    (tests/test_hpo.py::test_anneal_tuner_beats_random_search): a pure
    single-start hill climb with fast decay LOSES to random-40 in 6D."""

    def __init__(self, seed: int = 0, t0: float = 1.0, decay: float = 0.92,
                 init_random: int = 10, explore_prob: float = 0.1,
                 budget: Optional[int] = None):
        """budget: total planned trial count, when known. The random-init
        phase is capped to budget//3 so a small sweep (e.g. the
        reference's default 10 trials, experiment_nni.py:139) still gets
        an annealing/exploitation phase — with init_random == budget the
        tuner silently degrades to pure random search."""
        self.rng = random.Random(seed)
        self.t = t0
        self.decay = decay
        if budget is not None:
            init_random = min(init_random, max(2, budget // 3))
        self.init_random = init_random
        self.explore_prob = explore_prob
        self.history: List[Tuple[Dict, float]] = []
        self.issued = 0

    def generate_parameters(self) -> Dict:
        # the init phase is counted in ISSUED params, not received
        # results: with trial concurrency, run_experiment draws up to
        # `concurrency` params before any result lands — gating on
        # len(history) would hand out that many extra random samples and
        # re-create the init-consumes-the-sweep degradation at small
        # budgets. history can lag issued, never exceed it.
        self.issued += 1
        if (self.issued <= self.init_random
                or not self.history
                or self.rng.random() < self.explore_prob):
            return sample_space(self.rng)
        best_params, _ = max(self.history, key=lambda kv: kv[1])
        params = {}
        for name in SEARCH_SPACE:
            u = _to_unit(name, best_params[name])
            u += self.rng.gauss(0.0, 0.3) * self.t
            params[name] = _from_unit(name, u)
        return params

    def receive_trial_result(self, params: Dict, value: float) -> None:
        self.history.append((params, value))
        if len(self.history) > self.init_random:
            self.t *= self.decay

    @property
    def best(self) -> Optional[Tuple[Dict, float]]:
        if not self.history:
            return None
        return max(self.history, key=lambda kv: kv[1])
