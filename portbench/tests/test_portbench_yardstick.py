"""The copied yardstick gives the bounds the port's records hold, and the
FLOP count stays what the benchmark states."""

import numpy as np

from portbench import flops, roofline


def chip_smoke_valid_count(shape=(8, 1024, 512), seed=0, classes=19):
    """The valid pixels of the labels the kernel records' CE phase drew:
    ~10% ignored and ~5% out of range (numpy ``default_rng(0)``)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, shape)
    r = rng.random(shape)
    y = np.where(r < 0.10, 255, y)
    y = np.where((r >= 0.10) & (r < 0.15), rng.integers(classes, 255, shape), y)
    return int(((y >= 0) & (y < classes)).sum())


def test_ce_bounds_are_the_records():
    n_valid = chip_smoke_valid_count()
    fwd, by_f = roofline.bound_ce((8, 19, 128, 64), (1024, 512), 2, n_valid,
                                  False)
    bwd, by_b = roofline.bound_ce((8, 19, 128, 64), (1024, 512), 2, n_valid,
                                  True)
    assert round(fwd, 4) == 0.0078 and by_f == "operations"
    assert round(bwd, 4) == 0.0155 and by_b == "operations"


def test_upsample_argmax_bound_is_the_record():
    ms, by = roofline.bound_upsample_argmax((8, 19, 64, 128), (512, 1024), 2)
    assert round(ms, 4) == 0.0058


def test_head_shapes():
    assert roofline.head_shapes(16, (1024, 512)) == [
        (16, 19, 128, 64), (16, 19, 128, 64), (16, 19, 64, 32)]


def test_flops_stated():
    # G to its three heads, 1x3x1024x512
    assert flops.g_forward(1, (1024, 512)) == 35_261_120_512


def test_step_flops_compose():
    g = flops.g_forward(8, (1024, 512))
    assert flops.train_step(16, (1024, 512)) == 6 * g
