"""The train step's choice between a replayed CUDA graph and the eager
step (``train/supervised.py``), on the CPU: the decision for every reason,
what a capture bakes in (``_fingerprint``, ``_capturable``), and the CPU
step, which is the eager NCHW step as before: its three phases' spans, no
graph counter, the same losses as the step written out. The graphed step
itself runs on the card (``tests/test_torch_cuda.py``)."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from dasemanticsegmentationaml_tpu_torch.ops import resize
from dasemanticsegmentationaml_tpu_torch.train import supervised as S
from dasemanticsegmentationaml_tpu_torch.train.optim import (
    make_optimizer, set_learning_rate)
from dasemanticsegmentationaml_tpu_torch.utils import logging_util as lu


class Tiny(nn.Module):
    """A conv, BN and three heads at strides 1, 2 and 4, as
    ``BiSeNet.features`` gives them."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.bn = nn.BatchNorm2d(8)
        self.head = nn.Conv2d(8, 19, 1)

    def features(self, x):
        y = self.head(F.relu(self.bn(self.conv(x))))
        return [y, F.avg_pool2d(y, 2), F.avg_pool2d(y, 4)]


@pytest.fixture(autouse=True)
def one_thread_and_tracing_off():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    lu.disable()
    yield
    lu.disable()
    torch.set_num_threads(threads)


def batches(n, b=2, hw=(16, 32), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, 19, (b, *hw))
        labels[:, 0] = 255
        out.append((torch.from_numpy(rng.standard_normal(
            (b, 3, *hw)).astype(np.float32)),
            torch.from_numpy(labels.astype(np.int32))))
    return out


def model_and_sgd(seed=0):
    torch.manual_seed(seed)
    model = Tiny().train()
    return model, make_optimizer("sgd", model.parameters(), 0.01,
                                 momentum=0.9, weight_decay=1e-4)


GRAPHED = dict(cuda=True, ohem=False, accumulator=False, training=True,
               capturable=True, known=True, shapes=1, warmed=True)


@pytest.mark.parametrize("change,want", [
    ({}, None),
    ({"cuda": False}, "cpu"),
    ({"ohem": True}, "ohem"),
    ({"accumulator": True}, "accumulator"),
    ({"training": False}, "eval"),
    ({"capturable": False}, "optimizer"),
    ({"known": False, "shapes": S.MAX_GRAPHS}, "shapes"),
    ({"known": False, "shapes": S.MAX_GRAPHS - 1, "warmed": False},
     "warmup"),
    ({"warmed": False}, "warmup"),
    ({"known": True, "shapes": S.MAX_GRAPHS}, None),
])
def test_eager_reason(change, want):
    """Each condition alone sends the step eagerly, under its reason; a
    shape that has a graph replays it however many shapes have one; a
    new shape beyond ``MAX_GRAPHS`` runs eagerly, before it a new shape
    takes its eager first step."""
    assert S.eager_reason(**{**GRAPHED, **change}) == want


def test_eager_reason_order():
    """The CPU decides first, then OHEM, the accumulator, eval mode and the
    optimizer, before any shape is looked at."""
    none = dict(cuda=False, ohem=True, accumulator=True, training=False,
                capturable=False, known=False, shapes=S.MAX_GRAPHS,
                warmed=False)
    got = []
    for key, value in [("cuda", True), ("ohem", False),
                       ("accumulator", False), ("training", True),
                       ("capturable", True), ("shapes", 0),
                       ("warmed", True)]:
        got.append(S.eager_reason(**none))
        none[key] = value
    got.append(S.eager_reason(**none))
    assert got == ["cpu", "ohem", "accumulator", "eval", "optimizer",
                   "shapes", "warmup", None]


@pytest.mark.parametrize("name,kw,want", [
    ("sgd", {}, True),
    ("adam", {}, False),
    ("rmsprop", {}, False),
])
def test_capturable_optimizers(name, kw, want):
    """SGD's step keeps no host state; Adam's and RMSprop's count their
    steps on the host unless built ``capturable``."""
    opt = make_optimizer(name, Tiny().parameters(), 0.01, **kw)
    assert S._capturable(opt) is want
    if not want:
        for group in opt.param_groups:
            group["capturable"] = True
        assert S._capturable(opt)


def test_fingerprint_holds_over_a_step_and_moves_with_what_a_capture_bakes_in():
    """A step (in place) leaves it, as does state loaded from the very
    tensors it holds; a new learning rate, new state tensors loaded by
    ``load_state_dict`` (a resume), cleared state and a parameter moved
    elsewhere each change it."""
    model, opt = model_and_sgd()
    step = S.make_train_step(model, opt)
    (x, y), = batches(1)
    step(x, y)
    tensors = [*model.parameters(), *model.buffers()]
    before = S._fingerprint(tensors, opt)
    step(x, y)
    assert S._fingerprint(tensors, opt) == before
    set_learning_rate(opt, 0.005)
    assert S._fingerprint(tensors, opt) != before
    set_learning_rate(opt, 0.01)
    assert S._fingerprint(tensors, opt) == before
    opt.load_state_dict(opt.state_dict())  # the same tensors: they stay
    assert S._fingerprint(tensors, opt) == before
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    assert S._fingerprint(tensors, opt) != before
    loaded = S._fingerprint(tensors, opt)
    opt.state.clear()
    assert S._fingerprint(tensors, opt) != loaded
    step(x, y)
    moved = S._fingerprint(tensors, opt)
    model.head.weight.data = model.head.weight.data.clone()
    assert S._fingerprint(tensors, opt) != moved


@pytest.mark.parametrize("amp_dtype", [None, torch.bfloat16])
def test_cpu_step_is_the_eager_step(amp_dtype):
    """On the CPU the step records ``train.forward``, ``train.backward``
    and ``train.optimizer`` each step, counts no replay, capture or eager
    step, and gives the losses and parameters of the eager step written
    out (zero_grad, the summed CE of the three heads, backward, SGD),
    bit for bit."""
    data = batches(3)
    model, opt = model_and_sgd()
    before = lu.snapshot()
    lu.enable()
    step = S.make_train_step(model, opt, amp_dtype=amp_dtype)
    got = [step(x, y) for x, y in data]
    lu.disable()
    spans = [s.name for s in lu.collect()["spans"]]
    assert spans == ["train.forward", "train.backward",
                     "train.optimizer"] * 3
    assert {k: v for k, v in lu.snapshot().items()
            if k.startswith("train.")} == {
        k: v for k, v in before.items() if k.startswith("train.")}

    ref_model, ref_opt = model_and_sgd()
    loss_fn = S.make_supervised_loss(ref_model, amp_dtype=amp_dtype)
    want = []
    for x, y in data:
        ref_opt.zero_grad(set_to_none=True)
        loss = loss_fn(x, y)
        loss.backward()
        ref_opt.step()
        want.append(loss.detach())
    assert [float(v) for v in got] == [float(v) for v in want]
    for a, b in zip(model.state_dict().values(),
                    ref_model.state_dict().values()):
        assert torch.equal(a, b)


def test_nearest_indices_are_copied_to_the_device_once():
    """The gather indices of a nearest upsample at a ratio that is not an
    integer are one cached tensor, made outside inference mode (a
    captured step can hold no host-to-device copy), and the upsample
    equals its gather from ``_nearest_indices``."""
    x = torch.randn(2, 4, 5, 7)
    with torch.inference_mode():
        rows = resize._nearest_on(5, 12, torch.device("cpu"))
        got = resize.upsample_nearest(x, (12, 9))
    assert not rows.is_inference()
    assert resize._nearest_on(5, 12, torch.device("cpu")) is rows
    want = x[:, :, resize._nearest_indices(5, 12)][
        :, :, :, resize._nearest_indices(7, 9)]
    assert torch.equal(got, want)
