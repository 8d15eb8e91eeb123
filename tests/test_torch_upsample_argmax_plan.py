"""The upsample+argmax kernel's plan, replayed in numpy on the CPU.

``csrc/upsample_argmax.cu`` runs only on a card. Its algorithm is checked
here: the column segments of ``ops/resize.py::tap_ranges`` (one thread
each), the row pass once a segment, the column pass and the running
argmax a pixel, each product and sum rounded to float32 on its own, the
finite scan for a segment whose row pass is finite and the NaN scan
otherwise, and the generic instance's chunks of 32 classes. The replay
must give the bits of the plain version ``upsample_argmax_reference``
(``torch.argmax``: the first NaN, otherwise the first of the largest) on
random-normal, tie-heavy and non-finite logits at the card test's shapes
(tests/test_torch_cuda.py). The band geometry and the staged, coalesced
stores are replayed too. No JAX here.
"""

import numpy as np
import pytest
import torch

from dasemanticsegmentationaml_tpu_torch.ops import resize
from dasemanticsegmentationaml_tpu_torch.ops.cuda import upsample_argmax as ua

#: classes a generic chunk keeps in registers (csrc/upsample_argmax.cu::kChunk)
CHUNK = 32
#: the H100's SMs, for the band geometry
SMS = 132

#: (logits shape, output size): the card test's cases
SHAPES = [
    ((2, 19, 64, 128), (512, 1024)),   # 512x1024 input, batch 2
    ((1, 19, 64, 128), (512, 1024)),   # the CLI's eval batch of 1
    ((1, 19, 7, 13), (37, 50)),        # odd sizes
    ((2, 19, 64, 128), (64, 128)),     # identity
    ((1, 19, 1, 13), (37, 50)),        # h = 1
    ((2, 3, 1, 1), (4, 4)),            # one source pixel, C = 3
    ((1, 19, 37, 50), (7, 13)),        # downsampling: empty segments
    ((1, 19, 5, 1), (9, 7)),           # w = 1: one segment a row
    ((2, 3, 16, 32), (128, 256)),      # C = 3, the generic instance
    ((2, 32, 16, 32), (128, 256)),     # C = 32, one generic chunk
    ((1, 40, 9, 11), (45, 61)),        # C = 40, two chunks
    ((2, 19, 13, 16), (100, 120)),     # ragged last band
    ((1, 19, 3, 1000), (5, 1100)),     # w > 256: one row a band
    ((1, 19, 2, 8), (2, 12500)),       # rows too wide to stage: stored straight
]


def nonfinite(x):
    """NaN, +inf and -inf at set places, one source pixel all NaN and one
    all -inf (in place; ``x`` is (B, C, h, w) float32)."""
    b, c, h, w = x.shape
    x[0, min(3, c - 1), h // 2, w // 3] = np.nan
    x[-1, c // 2, 0, w - 1] = np.inf
    x[0, c - 1, h - 1, 0] = -np.inf
    x[-1, :, h - 1, w // 2] = np.nan
    x[0, :, 0, w // 2] = -np.inf
    return x


def make_logits(shape, seed, kind):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if kind == "ties":  # small integers: exact ties between classes
        x = np.round(x * 4).astype(np.float32)
    elif kind == "nonfinite":
        x = nonfinite(x)
    return x


def _lerp(w0, t, a, b):
    return w0 * a + t * b  # float32: each product and the sum rounded apart


def replay(x, out_hw, rule="torch"):
    """The kernel's work in numpy float32, segment by segment: (B, H, W)
    int32. ``rule="parent"``: the earlier kernel's `c == 0 || u > best`
    on every pixel, which skips a NaN."""
    b, c, h, w = x.shape
    out_h, out_w = out_hw
    lo_y, hi_y, ty = resize._align_corners_taps(h, out_h)
    _, hi_x, tx = resize._align_corners_taps(w, out_w)
    xr = resize.tap_ranges(w, out_w)
    one = np.float32(1)
    wy, wy0 = ty[None, None, :], one - ty[None, None, :]
    out = np.full((b, out_h, out_w), -1, np.int32)
    for j in range(w):
        x0, x1 = int(xr[j, 0]), int(xr[j, 1])
        if x0 == x1:
            continue
        hi = int(hi_x[x0])
        assert (hi_x[x0:x1] == hi).all()
        wx, wx0 = tx[x0:x1], one - tx[x0:x1]
        # row pass, once a segment: (B, C, H) at columns j and hi
        rl = _lerp(wy0, wy, x[:, :, lo_y, j], x[:, :, hi_y, j])
        rh = _lerp(wy0, wy, x[:, :, lo_y, hi], x[:, :, hi_y, hi])
        best = np.full((b, out_h, x1 - x0), -np.inf, np.float32)
        arg = np.zeros((b, out_h, x1 - x0), np.int32)
        # one chunk of 19 (the <T, 19> instance) or chunks of 32
        chunk = c if c == 19 else CHUNK
        for c0 in range(0, c, chunk):
            cls = range(c0, min(c, c0 + chunk))
            if c0 > 0:  # the earlier chunks' class, recomputed
                pick = arg[:, None]
                best = _lerp(wx0, wx,
                             np.take_along_axis(rl[..., None], pick, 1),
                             np.take_along_axis(rh[..., None], pick, 1))[:, 0]
            bad = ~(np.isfinite(rl[:, cls]) & np.isfinite(rh[:, cls])).all(1)
            nan_scan = bad[..., None]
            for k in cls:
                u = _lerp(wx0, wx, rl[:, k, :, None], rh[:, k, :, None])
                if rule == "parent":
                    take = (u > best) | (k == 0)
                else:
                    take = np.where(nan_scan, (best == best) & ~(u <= best),
                                    u > best)
                best = np.where(take, u, best)
                arg = np.where(take, k, arg)
        out[:, :, x0:x1] = arg
    return out


def plain(x, out_hw, dtype=torch.float32):
    return ua.upsample_argmax_reference(torch.from_numpy(x).to(dtype),
                                        out_hw).numpy()


@pytest.mark.parametrize("in_size,out_size", [
    (128, 1024), (64, 512), (7, 37), (13, 50), (1, 9), (5, 1), (1, 7),
    (50, 13), (11, 61), (16, 120), (64, 64)])
def test_segments_cover_each_column_once(in_size, out_size):
    """The lo ranges partition [0, W) in order, and every x of a segment
    has the segment's one hi tap, j or j + 1."""
    xr = resize.tap_ranges(in_size, out_size)
    _, hi_x, _ = resize._align_corners_taps(in_size, out_size)
    cover = np.concatenate([np.arange(a, b) for a, b in xr[:, :2]])
    np.testing.assert_array_equal(cover, np.arange(out_size))
    for j, (x0, x1) in enumerate(xr[:, :2]):
        if x0 < x1:
            assert len(set(hi_x[x0:x1])) == 1
            assert hi_x[x0] in (j, min(j + 1, in_size - 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["normal", "ties", "nonfinite"])
@pytest.mark.parametrize("shape,out_hw", SHAPES)
def test_replay_equals_plain_version(shape, out_hw, kind, dtype):
    x = make_logits(shape, 0, kind)
    x = torch.from_numpy(x).to(dtype).float().numpy()  # bf16 widened exactly
    with np.errstate(invalid="ignore", over="ignore"):
        got = replay(x, out_hw)
    np.testing.assert_array_equal(got, plain(x, out_hw))


def test_non_finite_case_catches_the_parent_rule():
    """The non-finite case is one the earlier rule got wrong: it skips a
    NaN that torch.argmax picks, at every pixel whose upsampled logits
    hold one (an inf makes NaN too: 0 * inf)."""
    x = make_logits((1, 19, 7, 13), 0, "nonfinite")
    with np.errstate(invalid="ignore", over="ignore"):
        want = plain(x, (37, 50))
        assert (replay(x, (37, 50), rule="parent") != want).sum() > 0
        np.testing.assert_array_equal(replay(x, (37, 50)), want)


def test_all_nan_pixel_picks_class_zero():
    x = np.full((1, 5, 2, 2), np.nan, np.float32)
    assert (plain(x, (3, 3)) == 0).all()
    assert (replay(x, (3, 3)) == 0).all()


def store_plan(b, out_h, out_w, rows):
    """Per block, the band's labels as the kernel stores them: their
    staging indices, then the scalar head, 16-byte vectors and scalar tail
    by global index."""
    n_bands = -(-out_h // rows)
    for blk in range(b * n_bands):
        bi, band = divmod(blk, n_bands)
        y0 = band * rows
        n = min(rows, out_h - y0) * out_w
        base = (bi * out_h + y0) * out_w
        head = min(n, (4 - (base & 3)) & 3)
        n_vec = (n - head) >> 2
        yield n, base, head, n_vec


@pytest.mark.parametrize("b,c,h,w,out_hw", [
    (8, 19, 64, 128, (512, 1024)), (1, 19, 64, 128, (512, 1024)),
    (2, 19, 128, 64, (1024, 512)), (2, 19, 13, 16, (100, 120)),
    (1, 19, 7, 13, (37, 50)), (1, 19, 5, 1, (9, 7)),
    (1, 19, 37, 50, (7, 13)), (1, 19, 3, 1000, (5, 1100)),
    (1, 19, 8, 16, (4, 20000))])
def test_band_geometry_and_stores(b, c, h, w, out_hw):
    """Rows per band from the work: at least one segment a thread where
    the rows and the staging buffer allow it, two blocks per SM where the
    image has the rows, the staging buffer within its limit (else one row
    a band, stored straight); every label of a band written once, its
    staging index inside the buffer, the vectors 16-byte aligned."""
    out_h, out_w = out_hw
    rows, staged = ua.band_geometry(b, out_h, out_w, w, SMS)
    assert 1 <= rows <= out_h
    full = -(-ua.THREADS // w)
    if rows > full:
        assert b * -(-out_h // rows) >= 2 * SMS
    assert rows >= min(full, out_h) or \
        ua.stage_bytes((rows + 1) * out_w) > ua.STAGE_LIMIT
    assert staged == (ua.stage_bytes(rows * out_w) <= ua.STAGE_LIMIT)
    assert staged or rows == 1
    if not staged:
        return
    seen = np.zeros(b * out_h * out_w, np.int32)
    for n, base, head, n_vec in store_plan(b, out_h, out_w, rows):
        g = np.arange(n)
        idx = g + (g >> 5)
        assert len(set(idx)) == n
        assert idx.max() < ua.stage_bytes(rows * out_w) // 4
        vec = base + head + 4 * np.arange(n_vec)
        assert (vec % 4 == 0).all()
        seen[base:base + head] += 1
        for k in range(4):
            seen[vec + k] += 1
        seen[base + head + 4 * n_vec:base + n] += 1
    assert (seen == 1).all()


def test_staging_pad_spreads_a_warp_over_the_banks():
    """At 64 x 128 -> 512 x 1024 a warp's lanes own 32 neighbouring
    segments of one row (8 or 9 pixels each). With one pad word every 32,
    each store of the pixel loop touches at most 2 words of one bank
    (without the pad: 5)."""
    xr = resize.tap_ranges(128, 1024)
    x0, x1 = xr[:, 0], xr[:, 1]

    def worst(index):
        most = 1
        for lane0 in range(0, 128, 32):
            for k in range(9):
                g = [x0[j] + k for j in range(lane0, lane0 + 32)
                     if x0[j] + k < x1[j]]
                banks = np.bincount(np.asarray(index(np.asarray(g))) % 32)
                most = max(most, banks.max())
        return most

    assert worst(lambda g: g + (g >> 5)) <= 2
    assert worst(lambda g: g) == 5
