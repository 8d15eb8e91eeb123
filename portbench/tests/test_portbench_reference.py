"""The frozen reference against the port on the CPU, fp32, 2x3x64x128."""

import pytest
import torch
import torch.nn.functional as F

from portbench import inputs
from portbench.drivers import common
from portbench.reference import model as M
from portbench.reference import steps as R

HW = (64, 128)


@pytest.fixture(scope="module")
def pair():
    state = inputs.g_state(common.g_shapes(), 3, "cpu")
    ref = R.build_g(state, "cpu")
    prog = common.program_g(state, "cpu")
    images = R.normalise(inputs.images(2, HW, inputs.generator(3, "i", "cpu"),
                                       "cpu"))
    labels = inputs.labels(2, HW, 32, 0.1,
                           inputs.generator(3, "l", "cpu"), "cpu")
    return state, ref, prog, images, labels


def test_state_dict_keys_match_the_port():
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import BiSeNet

    with torch.device("meta"):
        assert list(BiSeNet(19).state_dict()) == list(M.BiSeNet(19).state_dict())


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_heads_match(pair, mode):
    _state, ref, prog, images, _labels = pair
    ref.train(mode == "train")
    prog.train(mode == "train")
    with torch.no_grad():
        for a, b in zip(ref.features(images), prog.features(images)):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_ce_loss_and_gradient_match(pair):
    from dasemanticsegmentationaml_tpu_torch.ops.cuda.fused_ce import (
        cross_entropy_upsampled)

    *_, labels = pair
    logits = torch.randn((2, 19, 8, 16), generator=torch.Generator()
                         .manual_seed(1)).requires_grad_()
    want = F.cross_entropy(M.upsample(logits, HW), labels.long(),
                           ignore_index=255)
    got = cross_entropy_upsampled(logits, labels.to(torch.int32), HW)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    (g_want,) = torch.autograd.grad(want, logits)
    (g_got,) = torch.autograd.grad(got, logits)
    torch.testing.assert_close(g_got, g_want, rtol=1e-4, atol=1e-7)


def test_labels_match(pair):
    from dasemanticsegmentationaml_tpu_torch.ops.cuda.upsample_argmax import (
        upsample_argmax)

    logits = torch.randn((2, 19, 8, 16),
                         generator=torch.Generator().manual_seed(2))
    want = M.upsample(logits, HW).argmax(1)
    got = upsample_argmax(logits, HW)
    assert (got.long() == want).float().mean() >= 0.9999


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    err8 = (R.fp8_round(x) - x).abs().max()
    err16 = (x.bfloat16().float() - x).abs().max()
    assert err8 > 4 * err16 > 0
