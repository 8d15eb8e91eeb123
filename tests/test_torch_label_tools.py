"""The port's copy of ``utils/label_tools.py`` against the JAX module, on
the CPU: the colour-code round trip and the one-hot variants,
``reverse_one_hot`` (numpy and torch), ``compute_global_accuracy``,
``cal_miou`` and the seeded ``RandomCrop``, on the same inputs.

Adds about 9 s alone on the CPU, most of it imports.
"""

import numpy as np
import pytest
import torch

from dasemanticsegmentationaml_tpu.utils import label_tools as theirs
from dasemanticsegmentationaml_tpu_torch.utils import label_tools as ours

CSV = """name,r,g,b,class_11
Sky,128,128,128,1
Building,128,0,0,1
Pole,192,192,128,0
Road,128,64,128,1
Void,0,0,0,0
"""


@pytest.fixture
def csv_path(tmp_path):
    path = tmp_path / "class_dict.csv"
    path.write_text(CSV)
    return str(path)


def _colour_label(rng, info, shape=(12, 17)):
    colours = np.array([v[:3] for v in info.values()], np.uint8)
    return colours[rng.integers(0, len(colours), shape)]


def test_colour_code_round_trip(csv_path):
    pytest.importorskip("pandas")
    info = ours.get_label_info(csv_path)
    assert info == theirs.get_label_info(csv_path)
    label = _colour_label(np.random.default_rng(0), info)
    for fn in ("one_hot_it", "one_hot_it_v11", "one_hot_it_v11_dice"):
        np.testing.assert_array_equal(getattr(ours, fn)(label, info),
                                      getattr(theirs, fn)(label, info))
    classes = ours.one_hot_it_v11(label, info)
    kept = np.isin(classes, [0, 1, 2])  # the class_11 == 1 entries
    classes = np.where(kept, classes, 3)  # the rest to the black void
    coded = ours.colour_code_segmentation(classes, info)
    np.testing.assert_array_equal(
        coded, theirs.colour_code_segmentation(classes, info))
    np.testing.assert_array_equal(coded[kept], label[kept])
    assert (coded[~kept] == 0).all() and kept.any() and (~kept).any()


def test_reverse_one_hot():
    scores = np.random.default_rng(1).standard_normal((5, 7, 9)).astype(
        np.float32)
    for axis in (0, -1):
        want = np.asarray(theirs.reverse_one_hot(scores, class_axis=axis))
        np.testing.assert_array_equal(
            ours.reverse_one_hot(scores, class_axis=axis), want)
        np.testing.assert_array_equal(
            ours.reverse_one_hot(torch.from_numpy(scores),
                                 class_axis=axis).numpy(), want)


def test_compute_global_accuracy():
    rng = np.random.default_rng(2)
    pred = rng.integers(0, 19, (4, 32, 32))
    label = np.where(rng.uniform(size=pred.shape) < 0.1, 255,
                     np.where(rng.uniform(size=pred.shape) < 0.5, pred,
                              rng.integers(0, 19, pred.shape)))
    assert (ours.compute_global_accuracy(pred, label)
            == theirs.compute_global_accuracy(pred, label))


def test_cal_miou(csv_path):
    pytest.importorskip("pandas")
    ious = [0.5, 0.25, 0.125]
    assert ours.cal_miou(ious, csv_path) == theirs.cal_miou(ious, csv_path)


@pytest.mark.parametrize("size,padding,pad_if_needed,shape", [
    (8, 0, False, (20, 30, 3)), ((10, 6), 2, False, (20, 30)),
    ((40, 50), 0, True, (20, 30, 3)), ((20, 30), 0, False, (20, 30))])
def test_random_crop(size, padding, pad_if_needed, shape):
    img = np.random.default_rng(3).integers(0, 255, shape, dtype=np.uint8)
    for seed in (0, 1, 7):
        np.testing.assert_array_equal(
            ours.RandomCrop(size, seed, padding, pad_if_needed)(img),
            theirs.RandomCrop(size, seed, padding, pad_if_needed)(img))
