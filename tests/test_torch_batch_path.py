"""The port's batch path on the CPU: per-device constants made once, eval
drawing its batches two ahead, and the histogram without a host readback.

The same paths run on a card under ``torch.cuda.set_sync_debug_mode
("error")`` in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from dasemanticsegmentationaml_tpu_torch.data import labels as port_labels
from dasemanticsegmentationaml_tpu_torch.data import pipeline
from dasemanticsegmentationaml_tpu_torch.ops.metrics import confusion_matrix
from dasemanticsegmentationaml_tpu_torch.train import evaluate as port_eval


def _batch(seed, n=2, h=8, w=16):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 40, (n, h, w), dtype=np.uint8)))


def test_prepare_batch_reuses_the_cached_constants():
    """A second call copies nothing: the mean, std and trainId LUT of the
    first call are reused, the same tensors."""
    cpu = torch.device("cpu")
    images, labels = _batch(0)
    pipeline.prepare_batch(images, labels, device=cpu, remap=True)
    norm_hits = pipeline.normalisation_on.cache_info().hits
    lut_hits = port_labels.train_id_lut_on.cache_info().hits
    first = (pipeline.normalisation_on(cpu), port_labels.train_id_lut_on(cpu))
    got = pipeline.prepare_batch(images, labels, device="cpu", remap=True)
    assert pipeline.normalisation_on.cache_info().hits > norm_hits + 1
    assert port_labels.train_id_lut_on.cache_info().hits > lut_hits + 1
    again = (pipeline.normalisation_on(cpu), port_labels.train_id_lut_on(cpu))
    assert all(a is b for a, b in zip(first[0], again[0]))
    assert first[1] is again[1]
    want = port_labels.train_id_lut()[labels.numpy()].astype(np.int32)
    np.testing.assert_array_equal(got[1].numpy(), want)


def test_cached_constants_made_in_inference_mode_serve_training():
    """Made outside inference mode even when first asked for inside it
    (evaluation), as ops/resize.py::taps_on: a training step after a
    validation can save them for its backward."""
    pipeline.normalisation_on.cache_clear()
    port_labels.train_id_lut_on.cache_clear()
    images, labels = _batch(1)
    with torch.inference_mode():
        pipeline.prepare_batch(images, labels, device=torch.device("cpu"),
                               remap=True)
    mean, std = pipeline.normalisation_on(torch.device("cpu"))
    lut = port_labels.train_id_lut_on(torch.device("cpu"))
    assert not any(t.is_inference() for t in (mean, std, lut))
    x = torch.ones(3, requires_grad=True)
    ((x * mean - std) ** 2).sum().backward()
    assert x.grad is not None


class _Logits(torch.nn.Module):
    """``features`` gives stride-2 logits and records how many batches the
    loader had handed out when it ran."""

    def __init__(self, drawn):
        super().__init__()
        self.drawn = drawn
        self.seen = []

    def features(self, images):
        self.seen.append(len(self.drawn))
        x = torch.nn.functional.avg_pool2d(images, 2)
        logits = torch.cat([x, -x, x * 2, x[:, :1]], 1)  # 10 classes
        return logits, None, None


@pytest.mark.parametrize("n_batches", [1, 2, 5])
def test_eval_draws_two_batches_ahead(n_batches):
    """Batch i reaches the model after batches i+1 and i+2 were prepared
    (JAX evaluate.py:199, ``device_prefetch(..., depth=2)``); the counts
    equal those of the batches one by one."""
    drawn = []
    batches = [_batch(10 + i) for i in range(n_batches)]

    def loader():
        for b in batches:
            drawn.append(b)
            yield b

    def prepare(batch):
        return pipeline.prepare_batch(*batch, device=torch.device("cpu"),
                                      remap=True)

    model = _Logits(drawn)
    hist, correct, total = port_eval.eval_counts(
        model, loader(), 10, prepare=prepare, device=torch.device("cpu"))
    assert model.seen == [min(i + 3, n_batches) for i in range(n_batches)]
    want_hist = torch.zeros(10, 10, dtype=torch.int64)
    want_correct = 0
    for b in batches:
        images, labels = prepare(b)
        pred = port_eval.predict(model, images, True)
        want_hist += confusion_matrix(labels, pred, 10)
        want_correct += int((pred == labels).sum())
    assert torch.equal(hist, want_hist)
    assert int(correct) == want_correct
    assert total == sum(b[1].numel() for b in batches)


@pytest.mark.parametrize("seed,num_classes", [(0, 19), (1, 3), (2, 32)])
def test_confusion_matrix_equals_bincount(seed, num_classes):
    """The index_add_ histogram counts what np.bincount counts: a pixel
    whose label and prediction both lie in [0, C), ignore and out-of-range
    values dropped."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(-2, num_classes + 3, (3, 17, 29))
    labels[rng.random(labels.shape) < 0.1] = 255
    preds = rng.integers(-1, num_classes + 2, labels.shape)
    got = confusion_matrix(torch.from_numpy(labels).int(),
                           torch.from_numpy(preds).int(), num_classes)
    ok = ((labels >= 0) & (labels < num_classes) & (preds >= 0)
          & (preds < num_classes))
    want = np.bincount((labels * num_classes + preds)[ok],
                       minlength=num_classes ** 2)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  want.reshape(num_classes, num_classes))
