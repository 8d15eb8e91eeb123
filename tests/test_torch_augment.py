"""The port's device augmentation (data/augment.py) against the JAX
package's, on the CPU.

jax.random and torch draw different streams, so the two are held on
explicit parameters:

* the pil-exact replay (``apply_family_with_params(pil_exact=True)``),
  with parameters from ``host_augment.sample_params``: CS-HF and B-GS-R
  bit-identical; H-RP within JAX's own envelope (at most 1e-3 of the
  pixels differ, by at most 1; tests/test_augment_parity.py:246-266), its
  labels identical;
* the training path: parameters drawn by the port's sampler go through the
  port's batch path and, one sample at a time, through JAX
  ``apply_family_with_params(pil_exact=False)``. Images within 1e-2 on
  the 0-255 scale and nearest-sampled labels identical, each on at least
  99.9% of the pixels; the rest are float32 floor and round ties of the
  warp (the port's eager ops against XLA's fused ones).

The sampler's ranges and applied share are JAX's, and ``(seed, epoch,
it)`` fixes a batch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dasemanticsegmentationaml_tpu.data import augment as jax_aug
from dasemanticsegmentationaml_tpu.data import host_augment as jax_host
from dasemanticsegmentationaml_tpu_torch.data import augment as aug
from dasemanticsegmentationaml_tpu_torch.data import host_augment
from dasemanticsegmentationaml_tpu_torch.data.pipeline import prepare_batch

H, W = 48, 64
MENUS = ("CS-HF", "H-RP", "B-GS-R")
#: the training path's bound: the share of pixels within 1e-2 (images)
#: or equal (labels)
SHARE = 0.999


def _batch(seed, n=4, h=H, w=W):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8),
            rng.integers(0, 35, (n, h, w), dtype=np.uint8))


@pytest.mark.parametrize("augment_labels", [False, True])
@pytest.mark.parametrize("aug_type", MENUS)
def test_pil_exact_replay_matches_jax(aug_type, augment_labels):
    images, labels = _batch(0, n=6)
    for i in range(6):
        p = host_augment.sample_params(aug_type,
                                       host_augment.rng_for(1, 0, i), H, W,
                                       apply_prob=0.8)
        want_img, want_lab = jax_aug.apply_family_with_params(
            jnp.asarray(images[i], jnp.float32), jnp.asarray(labels[i]),
            aug_type, p, augment_labels=augment_labels, pil_exact=True)
        got_img, got_lab = aug.apply_family_with_params(
            torch.from_numpy(images[i]).float(), torch.from_numpy(labels[i]),
            aug_type, p, augment_labels=augment_labels, pil_exact=True)
        d = np.abs(got_img.numpy() - np.asarray(want_img))
        if aug_type == "H-RP":
            assert (d > 0).mean() <= 1e-3 and d.max() <= 1.0, (i, d.max())
        else:
            assert not d.any(), (i, d.max())
        np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))


def _jax_params(aug_type, params, i):
    """Sample ``i`` of the port's batched parameters in JAX's schema."""
    out = {"applied": bool(params["applied"][i])}
    for key in ("contrast", "saturation", "hue", "brightness", "angle"):
        if key in params:
            out[key] = float(params[key][i])
    if "coeffs" in params:
        out["coeffs"] = [float(v) for v in params["coeffs"][i]]
    return out


@pytest.mark.parametrize("aug_type", MENUS)
def test_training_path_matches_jax(aug_type):
    """Parameters from the port's sampler (H-RP's coefficients solved by
    the port) through the port's batch path and through JAX one sample at
    a time: images within 1e-2 and labels equal on >= 99.9% of pixels."""
    images, labels = _batch(1, n=6)
    gen = aug.batch_generator(5, 0, 0, torch.device("cpu"))
    params = aug.sample_params(aug_type, 6, H, W, gen)
    assert 0 < int(params["applied"].sum()) < 6  # both branches are seen
    got_img, got_lab = aug.apply_params(
        torch.from_numpy(images).float(), torch.from_numpy(labels), aug_type,
        params, augment_labels=True)
    for i in range(6):
        want_img, want_lab = jax_aug.apply_family_with_params(
            jnp.asarray(images[i], jnp.float32), jnp.asarray(labels[i]),
            aug_type, _jax_params(aug_type, params, i), augment_labels=True,
            pil_exact=False)
        d = np.abs(got_img[i].numpy() - np.asarray(want_img))
        assert (d <= 1e-2).mean() >= SHARE, (i, (d <= 1e-2).mean())
        assert (got_lab[i].numpy() == np.asarray(want_lab)).mean() >= SHARE


@pytest.mark.parametrize("aug_type", MENUS)
def test_single_sample_float_path_equals_the_batch_path(aug_type):
    """``apply_family_with_params(pil_exact=False)`` is the batch path on a
    batch of one, bit for bit."""
    images, labels = _batch(2, n=3)
    p = aug.sample_params(aug_type, 3, H, W, torch.Generator().manual_seed(3),
                          apply_prob=1.0)
    want = aug.apply_params(torch.from_numpy(images).float(),
                            torch.from_numpy(labels), aug_type, p,
                            augment_labels=True)
    for i in range(3):
        got = aug.apply_family_with_params(
            torch.from_numpy(images[i]).float(), torch.from_numpy(labels[i]),
            aug_type, _jax_params(aug_type, p, i), augment_labels=True,
            pil_exact=False)
        assert torch.equal(got[0], want[0][i])
        assert torch.equal(got[1], want[1][i])


def test_sampler_ranges_match_jax():
    """Over 400 draws: the applied share is 0.5 within 0.1 (5 binomial
    sigma); the factors lie in JAX's ranges (augment.py:583-612:
    contrast [2, 5), saturation [1, 3), hue [-0.2, 0.2), brightness
    [1, 2), angle [-90, 90)) and reach near both ends; the perspective
    corners take exactly the values JAX's sampler takes over 400 keys."""
    n, h, w = 400, 16, 32
    gen = torch.Generator().manual_seed(0)
    ranges = {"contrast": (2.0, 5.0), "saturation": (1.0, 3.0),
              "hue": (-0.2, 0.2), "brightness": (1.0, 2.0),
              "angle": (-90.0, 90.0)}
    for aug_type in MENUS:
        p = aug.sample_params(aug_type, n, h, w, gen)
        assert abs(float(p["applied"].float().mean()) - 0.5) <= 0.1
        for key, (lo, hi) in ranges.items():
            if key in p:
                v = p[key]
                assert float(v.min()) >= lo and float(v.max()) < hi
                assert float(v.min()) < lo + 0.05 * (hi - lo)
                assert float(v.max()) > hi - 0.05 * (hi - lo)
    start, end = aug.sample_perspective_endpoints(n, h, w, gen)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jax_start, jax_end = jax.vmap(
        lambda k: jax_aug.sample_perspective_endpoints(k, h, w, 0.5))(keys)
    np.testing.assert_array_equal(start.numpy(), np.asarray(jax_start))
    for corner in range(4):
        for axis in range(2):
            assert (set(end[:, corner, axis].tolist())
                    == set(np.asarray(jax_end)[:, corner, axis].tolist()))


def test_perspective_coeffs_match_the_host_solve():
    """The batched float32 solve against the float64 least squares of
    ``host_augment.perspective_coeffs`` (torchvision's), within 1e-4 of
    each coefficient's size, on the sampler's corners."""
    start, end = aug.sample_perspective_endpoints(
        16, H, W, torch.Generator().manual_seed(4))
    got = aug.perspective_coeffs(start, end).double()
    for i in range(16):
        want = np.asarray(host_augment.perspective_coeffs(
            start[i].tolist(), end[i].tolist()))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_prepare_batch_augmentation_is_keyed_by_seed_epoch_and_step():
    """The same (seed, epoch, it) gives the same batch; another epoch or
    step another; no augmentation leaves the unaugmented batch."""
    images, labels = _batch(3, n=4)
    cpu = torch.device("cpu")

    def prepare(aug_type, seed, epoch, it):
        gen = aug.batch_generator(seed, epoch, it, cpu)
        return prepare_batch(images, labels, device=cpu, remap=True,
                             aug_type=aug_type, generator=gen,
                             augment_labels=True)

    plain = prepare_batch(images, labels, device=cpu, remap=True)
    for aug_type in MENUS:
        a = prepare(aug_type, 0, 1, 2)
        b = prepare(aug_type, 0, 1, 2)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for other in (prepare(aug_type, 0, 2, 2), prepare(aug_type, 0, 1, 3)):
            assert not torch.equal(a[0], other[0])
        assert not torch.equal(a[0], plain[0])
        assert a[0].shape == plain[0].shape and a[1].dtype == torch.int32
    with pytest.raises(ValueError, match="generator"):
        prepare_batch(images, labels, device=cpu, aug_type="CS-HF")


def test_unapplied_samples_are_left_as_they_are():
    images, labels = _batch(4, n=4)
    imgs = torch.from_numpy(images).float()
    labs = torch.from_numpy(labels)
    for aug_type in MENUS:
        p = aug.sample_params(aug_type, 4, H, W,
                              torch.Generator().manual_seed(5))
        p["applied"] = torch.tensor([True, False, True, False])
        out, out_lab = aug.apply_params(imgs, labs, aug_type, p,
                                        augment_labels=True)
        for i in (1, 3):
            assert torch.equal(out[i], imgs[i])
            assert torch.equal(out_lab[i], labs[i])
        assert not torch.equal(out[0], imgs[0])


def test_hrp_label_warp_uses_the_image_grid():
    """Pil-exact H-RP with labels (JAX tests/test_augment_parity.py:269):
    the label's fill mask is the image's, and an integer translation
    shifts the label exactly; a source coordinate of exactly w - 0.5 is
    outside (the half-open bound)."""
    rng = np.random.default_rng(6)
    h, w = 16, 24
    img = torch.from_numpy(np.maximum(rng.integers(0, 256, (h, w, 3)), 1)
                           .astype(np.float32))
    label = torch.from_numpy(rng.integers(0, 19, (h, w), dtype=np.uint8))
    params = {"applied": True, "hue": 0.0, "coeffs": [1, 0, 3, 0, 1, 2, 0, 0]}
    out_img, out_lab = aug.apply_family_with_params(
        img, label, "H-RP", params, augment_labels=True)
    np.testing.assert_array_equal((out_img == 0).all(-1).numpy(),
                                  (out_lab == aug.IGNORE_FILL).numpy())
    np.testing.assert_array_equal(out_lab[:h - 2, :w - 3].numpy(),
                                  label[2:, 3:].numpy())
    edge = {"applied": True, "hue": 0.0,
            "coeffs": [1, 0, w - 0.5, 0, 1, 0, 0, 0]}
    _, lab_edge = aug.apply_family_with_params(img, label, "H-RP", edge,
                                               augment_labels=True)
    assert bool((lab_edge == aug.IGNORE_FILL).all())


def test_rotation_matches_the_host_twin_at_every_angle_sign():
    """Pil-exact rotation (int64 16.16 walk, no overflow guard) equals
    ``augment_pil_exact.rotate_nearest`` and JAX's int32 walk."""
    from dasemanticsegmentationaml_tpu_torch.data import augment_pil_exact

    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for angle in (-90.0, -33.3, 0.0, 12.5, 45.0, 89.99):
        got = aug.rotate_nearest_pil_exact(torch.from_numpy(img).float(),
                                           angle).numpy()
        np.testing.assert_array_equal(
            got, augment_pil_exact.rotate_nearest(img, angle))
        np.testing.assert_array_equal(got, np.asarray(
            jax_aug.rotate_nearest_pil_exact(jnp.asarray(img, jnp.float32),
                                             angle)))


def test_host_params_schema_is_jax_host_schema():
    """``host_augment.sample_params`` draws what the JAX package draws."""
    for aug_type in MENUS:
        for idx in range(5):
            got = host_augment.sample_params(
                aug_type, host_augment.rng_for(9, 1, idx), H, W)
            want = jax_host.sample_params(
                aug_type, jax_host.rng_for(9, 1, idx), H, W)
            assert got == want
