"""``--eval_scan_window`` on the CPU: the windowed evaluation counts what
the per-batch one counts, and what JAX's ``lax.scan`` windows count.

On the CPU the port has no graph: every batch takes the eager step, so
the counts must equal the per-batch ones exactly, and JAX's, whose
windows group the batches (the first batch's shape, another shape eager,
the last window's leftovers eager; JAX evaluate.py:205-240). The
model is one 1x1 convolution with small integer weights on small integer
images, in both frameworks, so every logit is exact and the predictions
(ties broken by the first maximum in both) are the same bits: the test is
of the windows, not of the network, whose parity
``tests/test_torch_eval.py`` holds. The card's grouping and its CUDA-graph
replay are held against eager on the card by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
from flax import linen as nn

from dasemanticsegmentationaml_tpu.train.evaluate import (
    evaluate as jax_evaluate)
from dasemanticsegmentationaml_tpu_torch import cli
from dasemanticsegmentationaml_tpu_torch.train import evaluate as port_eval

from test_torch_eval import H as CLI_H, W as CLI_W, _mk_cityscapes, _seeded_pth

H, W, C = 16, 32, 19


class _JaxConv(nn.Module):
    @nn.compact
    def __call__(self, x, train=False):
        y = nn.Conv(C, (1, 1), use_bias=False, precision="highest")(x)
        return y, y, y


class _PortConv(torch.nn.Module):
    def __init__(self, weight):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, C, 1, bias=False)
        with torch.no_grad():
            self.conv.weight.copy_(weight)

    def features(self, x):
        y = self.conv(x)
        return y, y, y

    def forward(self, x):
        return self.features(x)


def _setup(odd_at):
    """Seven batches of 2 and one of 1 (at ``odd_at``), NHWC numpy, labels
    with the 255 ignore label; the weights of both models."""
    rng = np.random.default_rng(2)
    kernel = rng.integers(-2, 3, (1, 1, 3, C)).astype(np.float32)
    batches = []
    for _ in range(7):
        img = rng.integers(-3, 4, (2, H, W, 3)).astype(np.float32)
        lab = np.where(rng.uniform(size=(2, H, W)) < 0.1, 255,
                       rng.integers(0, C, (2, H, W))).astype(np.int32)
        batches.append((img, lab))
    batches.insert(odd_at, (rng.integers(-3, 4, (1, H, W, 3)).astype(
        np.float32), rng.integers(0, C, (1, H, W)).astype(np.int32)))
    weight = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    return batches, kernel, weight


def _port_prepare(batch):
    img, lab = batch
    return (torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))),
            torch.from_numpy(lab))


@pytest.mark.parametrize("odd_at", [7, 3, 0])
@pytest.mark.parametrize("fused", [False, True])
def test_port_scan_window_counts_equal_per_batch_and_jax(odd_at, fused):
    """tests/test_train.py:377 for the port: windows of 0, 3 and 8 (two
    windows of 3 and a leftover; one window never filled) give the same
    int64 counts, and evaluate's precision and mIoU are JAX's
    ``evaluate(..., scan_window=3, flush_every=4)`` on the same weights."""
    import jax.numpy as jnp

    batches, kernel, weight = _setup(odd_at)
    model = _PortConv(weight).eval()
    kw = dict(prepare=_port_prepare, device=torch.device("cpu"),
              use_fused_kernel=fused)
    counts = {k: port_eval.eval_counts(model, batches, C, scan_window=k, **kw)
              for k in (0, 3, 8)}
    hist0, correct0, total0 = counts[0]
    assert total0 == sum(lab.size for _, lab in batches)
    for k, (hist, correct, total) in counts.items():
        assert torch.equal(hist, hist0), k
        assert int(correct) == int(correct0) and total == total0, k
    jax_vars = {"params": {"Conv_0": {"kernel": jnp.asarray(kernel)}}}
    want = jax_evaluate(_JaxConv(), jax_vars, batches, C,
                        prepare=lambda b: (jnp.asarray(b[0]),
                                           jnp.asarray(b[1])),
                        print_results=False, scan_window=3, flush_every=4)
    got = port_eval.evaluate(model, batches, C, scan_window=3,
                             print_results=False, **kw)
    assert got[0] == pytest.approx(want[0], abs=1e-12)
    assert got[1] == pytest.approx(want[1], abs=1e-12)


def test_port_cli_scan_window_equals_per_batch(tmp_path):
    """The ``--domain_shift`` CLI with ``--eval_scan_window 2`` over five
    images of batch 1 (two windows and a leftover) gives the CLI's
    numbers without it, exactly."""
    root = str(tmp_path / "data")
    _mk_cityscapes(root, "val", n=5)
    pth = str(tmp_path / "best.pth")
    _seeded_pth(pth)
    argv = ["--root", root, "--domain_shift", "True", "--pretrain_path", pth,
            "--crop_height", str(CLI_H), "--crop_width", str(CLI_W),
            "--faithful_resize", "False", "--num_workers", "1", "--dtype",
            "float32", "--tensorboard", "False", "--cuda", "cpu"]
    plain = cli.main(argv)
    windowed = cli.main(argv + ["--eval_scan_window", "2"])
    assert windowed == plain
    assert 0.0 < plain["miou"] <= 1.0
