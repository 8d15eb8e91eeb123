"""Learning-rate schedules.

``poly_lr``, ``PolyLR`` and ``ConstantLR`` are copied verbatim from
``dasemanticsegmentationaml_tpu/ops/schedules.py`` (:25-115), which the
port may not import. The reference decays the LR once per epoch with a
polynomial schedule (reference utils.py:11-26): ``lr = init_lr * (1 -
iter/max_iter) ** power``. The supervised trainer uses ``mode="standard"``
(reference train.py:71; JAX supervised.py:135); ``"compounding"`` is the
domain-adaptation schedule (reference train.py:185-186). ``ConstantLR``
is the discriminator's LR under ``--nni_faithful_lr`` (reference
train_nni.py:97-98).
"""

from __future__ import annotations

from dataclasses import dataclass


def poly_lr(
    init_lr: float, iteration: int, max_iter: int = 300, power: float = 0.9
) -> float:
    """Reference utils.py:24 formula."""
    return init_lr * (1.0 - iteration / max_iter) ** power


@dataclass
class PolyLR:
    """Stateful per-epoch poly LR.

    mode='standard'    lr(e) = base * (1 - e/E)^p          (reference train.py:71)
    mode='compounding' lr(e) = lr(e-1) * (1 - e/E)^p       (reference train.py:185)
    """

    base_lr: float
    max_iter: int
    power: float = 0.9
    mode: str = "standard"

    def __post_init__(self):
        if self.mode not in ("standard", "compounding"):
            raise ValueError(f"unknown PolyLR mode: {self.mode}")
        self._current = self.base_lr

    def __call__(self, epoch: int) -> float:
        if self.mode == "standard":
            self._current = poly_lr(self.base_lr, epoch, self.max_iter, self.power)
        else:
            self._current = poly_lr(
                self._current, epoch, self.max_iter, self.power
            )
        return self._current

    def fast_forward(self, start_epoch: int) -> None:
        """Replay epochs [0, start_epoch) so a resumed run continues the
        schedule an uninterrupted run would be on.

        Matters only for mode='compounding', whose state is the product
        of every previous epoch's decay factor: without the replay a
        --resume at epoch k would restart from base_lr and train with an
        LR orders of magnitude above the run it claims to continue
        (standard mode is stateless in the epoch, so this is a no-op
        beyond setting _current)."""
        for epoch in range(start_epoch):
            self(epoch)


@dataclass
class ConstantLR:
    """A never-decayed LR with the PolyLR call surface (JAX
    schedules.py:92-115): under the NNI trial's faithful LR dataflow
    (train_nni.py:97-98) both ``poly_lr_scheduler`` calls mutate the
    generator's optimizer, so the discriminator trains at a constant
    ``learning_rate_D`` (see train/adversarial.py::train_da)."""

    base_lr: float

    def __call__(self, epoch: int) -> float:
        return self.base_lr

    def fast_forward(self, start_epoch: int) -> None:
        pass
