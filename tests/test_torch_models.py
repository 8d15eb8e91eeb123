"""The port's STDCNet813 and BiSeNet against the JAX modules, on the CPU.

Weights cross over the way a user's checkpoint does: seeded numpy values
in the JAX variables, ``variables_to_torch_state`` (torch_io.py:590) to
reference-named keys, ``load_reference_state`` into the port. The JAX
variable tree comes from ``jax.eval_shape`` of the init, so no full-width
init is compiled. BN statistics are drawn away from identity so that a
wrong running mean, variance or eps would show.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dasemanticsegmentationaml_tpu.models import STDCNet813 as JaxSTDCNet813
from dasemanticsegmentationaml_tpu.models.bisenet import BiSeNet as JaxBiSeNet
from dasemanticsegmentationaml_tpu.utils import torch_io
from dasemanticsegmentationaml_tpu_torch.models import (BiSeNet, STDCNet813,
                                                        build_bisenet)
from dasemanticsegmentationaml_tpu_torch.utils.weights import (
    load_pretrain, load_reference_state)


def seeded_variables(init_fn, seed):
    """JAX variables of ``init_fn``'s structure, filled from numpy."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("bias", "mean"):
            v = 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = 0.5 + rng.random(shape)
        else:
            raise KeyError(name)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init_fn))


def nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def assert_close_nhwc(got_nchw, want_nhwc):
    want = np.asarray(want_nhwc)
    got = got_nchw.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def bisenet_pair():
    jax_model = JaxBiSeNet(n_classes=19)
    variables = seeded_variables(
        lambda: jax_model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 64, 128, 3)),
                               method=JaxBiSeNet.full_init), seed=0)
    state = torch_io.variables_to_torch_state(variables)
    model = BiSeNet(19).eval()
    load_reference_state(model, state, strict=True)
    return jax_model, variables, state, model


def test_param_counts():
    """tests/test_models.py's numbers for the JAX package."""
    model = BiSeNet(19)
    assert sum(p.numel() for p in model.parameters()) == 11_550_496
    assert sum(p.numel() for p in model.cp.backbone.parameters()) == 8_443_552


def test_backbone_stage_param_counts():
    model = STDCNet813()
    expected = [928, 18_560, 111_488, 134_656, 474_880, 537_600,
                1_891_840, 2_148_352]
    got = [sum(p.numel() for p in f.parameters()) for f in model.features]
    assert got == expected


def test_strict_load_takes_every_reference_key(bisenet_pair):
    _, _, state, model = bisenet_pair
    assert len(state) == 216
    own = {k: v for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert sorted(own) == sorted(state)
    for key in ("cp.backbone.features.2.avd_layer.0.weight",
                "cp.backbone.features.2.conv_list.1.bn.running_var",
                "cp.backbone.fc.weight", "cp.backbone.bn.running_mean"):
        np.testing.assert_array_equal(own[key].numpy(), state[key])


def test_load_strips_prefix_and_drops_views(bisenet_pair):
    _, _, state, _ = bisenet_pair
    noisy = {f"module.{k}": v for k, v in state.items()}
    noisy["module.cp.backbone.x8.0.conv_list.0.conv.weight"] = np.zeros(1)
    noisy["module.cp.backbone.features.0.bn.num_batches_tracked"] = np.zeros(())
    model = BiSeNet(19)
    assert len(load_reference_state(model, noisy, strict=True)) == 216


@pytest.mark.parametrize("edit", ["missing", "unexpected", "shape"])
def test_strict_load_raises(bisenet_pair, edit):
    _, _, state, _ = bisenet_pair
    state = dict(state)
    key = "conv_out.conv_out.weight"
    if edit == "missing":
        del state[key]
    elif edit == "unexpected":
        state["conv_out.extra.weight"] = np.zeros(3, np.float32)
    else:
        state[key] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        load_reference_state(BiSeNet(19), state, strict=True)


@pytest.mark.parametrize("block_type", ["cat", "add"])
def test_narrow_stdcnet_matches_jax(block_type):
    kw = dict(base=16, layers=(1, 1, 1), block_num=4, block_type=block_type,
              num_classes=10)
    jax_model = JaxSTDCNet813(**kw)

    def init():
        x = jnp.zeros((1, 64, 64, 3))
        return jax_model.init(jax.random.PRNGKey(0), x,
                              method=JaxSTDCNet813.classify)

    variables = seeded_variables(init, seed=1)
    model = STDCNet813(**kw).eval()
    load_reference_state(model, torch_io.variables_to_torch_state(variables))
    x = np.random.default_rng(2).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    want = jax_model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(nchw(x))
        logits = model.classify(nchw(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert_close_nhwc(g, w)
    want_logits = np.asarray(jax_model.apply(
        variables, jnp.asarray(x), method=JaxSTDCNet813.classify))
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-4,
                               atol=1e-4 * np.abs(want_logits).max())


@pytest.mark.parametrize("method", ["features", "forward"])
def test_bisenet_matches_jax(bisenet_pair, method):
    jax_model, variables, _, model = bisenet_pair
    x = np.random.default_rng(3).standard_normal(
        (2, 64, 128, 3)).astype(np.float32)
    if method == "features":
        want = jax_model.apply(variables, jnp.asarray(x), train=False,
                               method=JaxBiSeNet.features)
        with torch.no_grad():
            got = model.features(nchw(x))
        shapes = [(2, 19, 8, 16), (2, 19, 8, 16), (2, 19, 4, 8)]
    else:
        want = jax_model.apply(variables, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = model(nchw(x))
        shapes = [(2, 19, 64, 128)] * 3
    assert [tuple(g.shape) for g in got] == shapes
    for g, w in zip(got, want):
        assert_close_nhwc(g, w)


def test_load_pretrain_full_pth(tmp_path, bisenet_pair, capsys):
    """A .pth written by the JAX package loads through torch.load."""
    _, _, state, model = bisenet_pair
    path = str(tmp_path / "best.pth")
    torch_io.write_torch_checkpoint(path, state)
    fresh = BiSeNet(19)
    load_pretrain(fresh, path)
    assert "(216 tensors)" in capsys.readouterr().out
    for (k, a), b in zip(fresh.state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(a, b), k


def test_load_pretrain_backbone_tar(tmp_path, bisenet_pair):
    """'STDCNet' without '.pth': a backbone state_dict under cp.backbone."""
    _, _, state, model = bisenet_pair
    prefix = "cp.backbone."
    backbone = {k[len(prefix):]: v for k, v in state.items()
                if k.startswith(prefix)}
    path = str(tmp_path / "STDCNet813M_73.91.tar")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in backbone.items()}}, path)
    fresh = BiSeNet(19)
    load_pretrain(fresh, path)
    for k, v in fresh.cp.backbone.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, model.cp.backbone.state_dict()[k]), k


def test_load_pretrain_zero_match_exits(tmp_path):
    path = str(tmp_path / "other.pth")
    torch.save({"unrelated.weight": torch.zeros(3)}, path)
    with pytest.raises(SystemExit):
        load_pretrain(BiSeNet(19), path)


def test_build_bisenet_is_seeded():
    a = build_bisenet(19, device="cpu", generator=torch.Generator().manual_seed(0))
    b = build_bisenet(19, device="cpu", generator=torch.Generator().manual_seed(0))
    c = build_bisenet(19, device="cpu", generator=torch.Generator().manual_seed(1))
    assert not a.training
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv_out.conv_out.weight"],
                           sc["conv_out.conv_out.weight"])
    rv = sa["cp.conv_avg.bn.running_var"]
    assert bool(((rv >= 0.5) & (rv <= 1.5)).all())
