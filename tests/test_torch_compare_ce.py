"""``chip_smoke.py --baseline`` on the CPU: the loader of the version
compared against (its CE and upsample+argmax modules), the CE forward
and backward calls it times, and the refusal to run without a card."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dasemanticsegmentationaml_tpu_torch.ops.cuda import (fused_ce,
                                                           upsample_argmax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _chip_smoke()


def _inputs(shape, out_hw, dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    y = rng.integers(0, shape[1], (shape[0], *out_hw))
    y = np.where(rng.random(y.shape) < 0.10, 255, y).astype(np.int32)
    return x.to(dtype).requires_grad_(), torch.from_numpy(y)


def test_baseline_is_a_second_copy_of_the_package():
    """The baseline is imported under its own name: its modules, counters
    and caches are not this checkout's, and on the CPU they compute what
    this checkout does."""
    base = chip_smoke.load_baseline(REPO, "fused_ce")
    assert base is not fused_ce
    assert base.__name__ == "baseline_torch_port.ops.cuda.fused_ce"
    assert os.path.samefile(base.__file__, fused_ce.__file__)
    assert base.cross_entropy_upsampled is not fused_ce.cross_entropy_upsampled
    assert chip_smoke.load_baseline(REPO, "fused_ce") is base
    x, labels = _inputs((2, 3, 4, 5), (7, 9), torch.float32)
    assert torch.equal(base.cross_entropy_upsampled(x, labels, (7, 9)),
                       fused_ce.cross_entropy_upsampled(x, labels, (7, 9)))
    base_ua = chip_smoke.load_baseline(REPO, "upsample_argmax")
    assert base_ua.__name__ == "baseline_torch_port.ops.cuda.upsample_argmax"
    assert base_ua.upsample_argmax is not upsample_argmax.upsample_argmax
    logits = x.detach()
    assert torch.equal(base_ua.upsample_argmax(logits, (7, 9)),
                       upsample_argmax.upsample_argmax(logits, (7, 9)))


def test_baseline_that_is_missing_raises(tmp_path, monkeypatch):
    monkeypatch.delitem(sys.modules, chip_smoke.BASELINE, raising=False)
    with pytest.raises(FileNotFoundError, match="no package"):
        chip_smoke.load_baseline(str(tmp_path), "fused_ce")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_calls(dtype, monkeypatch):
    """The timed forward builds no graph; the timed backward can be called
    again and again, and gives autograd's gradient each time."""
    shape, out_hw = (2, 19, 8, 4), (64, 32)
    x, labels = _inputs(shape, out_hw, dtype)
    fn = fused_ce.cross_entropy_upsampled
    fwd, bwd = chip_smoke.ce_calls(fn, x, labels, out_hw)
    assert fwd() is None and x.grad is None
    want, = torch.autograd.grad(fn(x, labels, out_hw), x)
    seen = []
    real_grad = torch.autograd.grad
    monkeypatch.setattr(torch.autograd, "grad",
                        lambda *a, **k: seen.append(real_grad(*a, **k)))
    bwd()
    bwd()
    monkeypatch.undo()
    assert len(seen) == 2 and x.grad is None
    for (got,) in seen:
        assert got.dtype == dtype and torch.equal(got, want)


def test_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--baseline", REPO],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout.strip() == ""
