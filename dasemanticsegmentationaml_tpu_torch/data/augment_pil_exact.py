"""Bit-exact numpy reimplementation of the PIL math behind the reference's
torchvision augmentations (reference GTAV.py:32-59).

A copy of ``dasemanticsegmentationaml_tpu/data/augment_pil_exact.py``
(numpy only), which the port may not import. The reference augments
through torchvision-on-PIL; every op below reproduces Pillow's C
semantics EXACTLY (validated over the full 2^24 RGB cube for the color
ops and over randomized warp/rotation suites — the JAX package's
tests/test_augment_parity.py re-pins each claim against the installed
Pillow):

* ``luma``            — convert("L"): (19595 R + 38470 G + 7471 B + 0x8000)>>16
                        (Pillow's L24 integer coefficients, not float 0.299...)
* ``_blend``          — Image.blend / ImageEnhance.enhance: float32
                        ``in1 + alpha*(in2-in1)``, clipped then TRUNCATED to
                        uint8 (Pillow Blend.c casts, it does not round)
* ``adjust_contrast`` — degenerate = solid int(mean(L)+0.5), the ImageStat
                        rounding, computed here in exact integer math
* ``adjust_hue``      — Pillow's float32 colorsys-style RGB<->HSV conversions
                        (H = trunc(fmod(h/6+1,1)*255) with the exact
                        float32/float64 mixing of Convert.c) + the uint8
                        wraparound shift torchvision applies to the H plane
* ``perspective_bilinear`` — ImagingGenericTransform: per-pixel double
                        homography eval at +0.5 centers, edge-clamped double
                        bilinear taps, truncated store, fill outside
                        [-0.5, size-0.5)
* ``rotate_nearest``  — Image.rotate(expand=False): PIL's Python-side matrix
                        (angle%360, round(cos,15)!) then Geometry.c's NEAREST
                        affine fast path, which is 16.16 FIXED-POINT integer
                        accumulation (xin = round(xo*65536) + y*round(a1*65536)
                        + x*round(a0*65536); index = xin>>16) — double-precision
                        reimplementations are off by one near ties; this one is
                        integer-for-integer identical

In the port this module is the plain version of the host path: the
native ops (native/augment.cpp through data/native_augment.py) that
``host_augment.HostAugment`` runs are held against it bit for bit
(tests/test_torch_host_augment.py), and the device path's pil-exact
replay (data/augment.py) takes its float64 perspective grid and
fixed-point rotation starts from here.

All functions take/return uint8 HWC numpy arrays.
"""

from __future__ import annotations

import math

import numpy as np


# ---------------------------------------------------------------- color ops
def luma(img: np.ndarray) -> np.ndarray:
    """Pillow convert("L"): integer ITU-R 601-2 with Pillow's exact
    coefficients and rounding."""
    r = img[..., 0].astype(np.int64)
    g = img[..., 1].astype(np.int64)
    b = img[..., 2].astype(np.int64)
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def _blend(degenerate, img: np.ndarray, factor: float) -> np.ndarray:
    """Image.blend(degenerate, img, factor) on uint8: float32 math,
    clip to [0,255], truncate (Pillow Blend.c)."""
    if factor == 1.0:
        return img.copy()
    d32 = np.asarray(degenerate, np.float32)
    t = d32 + np.float32(factor) * (img.astype(np.float32) - d32)
    out = np.where(t >= 255.0, np.float32(255.0),
                   np.where(t <= 0.0, np.float32(0.0), np.trunc(t)))
    return out.astype(np.uint8)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """ImageEnhance.Brightness: blend against black."""
    return _blend(np.float32(0.0), img, factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """ImageEnhance.Contrast: blend against a solid image of
    int(mean(L)+0.5). The ImageStat float64 mean + round is computed here
    exactly with integers: floor(s/n + 0.5) == (2s+n)//(2n)."""
    l_plane = luma(img).astype(np.int64)
    s = int(l_plane.sum())
    n = int(l_plane.size)
    mean = (2 * s + n) // (2 * n)
    return _blend(np.float32(mean), img, factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    """ImageEnhance.Color: blend against the per-pixel L plane."""
    return _blend(luma(img).astype(np.float32)[..., None], img, factor)


def rgb2hsv(img: np.ndarray) -> np.ndarray:
    """Pillow Convert.c rgb2hsv (colorsys-style), float32 per-pixel with the
    exact float64 promotion points of the C expression; validated equal to
    Image.convert("HSV") over the full 2^24 cube."""
    r = img[..., 0].astype(np.int32)
    g = img[..., 1].astype(np.int32)
    b = img[..., 2].astype(np.int32)
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    uv = maxc - minc
    cr = np.where(uv == 0, np.float32(1), uv.astype(np.float32))
    s32 = (uv.astype(np.float32)
           / np.where(maxc == 0, np.float32(1), maxc.astype(np.float32))
           ).astype(np.float32)
    rc = ((maxc - r).astype(np.float32) / cr).astype(np.float32)
    gc = ((maxc - g).astype(np.float32) / cr).astype(np.float32)
    bc = ((maxc - b).astype(np.float32) / cr).astype(np.float32)
    # C: `h = 2.0 + rc - bc` etc — double expression stored into float h
    h64 = np.where(
        maxc == r, bc.astype(np.float64) - gc.astype(np.float64),
        np.where(maxc == g,
                 2.0 + rc.astype(np.float64) - bc.astype(np.float64),
                 4.0 + gc.astype(np.float64) - rc.astype(np.float64)))
    h = h64.astype(np.float32)
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(np.float32)
    hq = np.trunc(h.astype(np.float64) * 255.0).astype(np.int64)
    sq = np.trunc(s32.astype(np.float64) * 255.0).astype(np.int64)
    return np.stack([np.where(uv == 0, 0, hq),
                     np.where(uv == 0, 0, sq), maxc],
                    axis=-1).astype(np.uint8)


def hsv2rgb(hsv: np.ndarray) -> np.ndarray:
    """Pillow Convert.c hsv2rgb; validated equal to HSV->RGB convert over
    the full cube (i = floor(h*6/255) double, p/q/t = C round())."""
    h = hsv[..., 0].astype(np.float64)
    s = hsv[..., 1].astype(np.int32)
    v = hsv[..., 2].astype(np.int32)
    x = h * 6.0 / 255.0
    i = np.floor(x).astype(np.int32)
    f = (x - i).astype(np.float32)
    fs = (s.astype(np.float32) / np.float32(255.0)).astype(np.float32)
    vf = v.astype(np.float64)
    p = np.clip(np.round(vf * (1.0 - fs.astype(np.float64))), 0, 255)
    q = np.clip(np.round(vf * (1.0 - fs.astype(np.float64)
                               * f.astype(np.float64))), 0, 255)
    t = np.clip(np.round(vf * (1.0 - fs.astype(np.float64)
                               * (1.0 - f.astype(np.float64)))), 0, 255)
    p = p.astype(np.uint8)
    q = q.astype(np.uint8)
    t = t.astype(np.uint8)
    vv = v.astype(np.uint8)
    im = i % 6

    def pick(opts):
        # where-chain instead of np.choose: same selection, ~4x faster
        # on uint8 planes (choose materializes the full 6-way stack)
        out = opts[5]
        for k in range(4, -1, -1):
            out = np.where(im == k, opts[k], out)
        return out

    r = pick([vv, q, p, p, t, vv])
    g = pick([t, vv, vv, q, p, p])
    b = pick([p, p, t, vv, vv, q])
    out = np.stack([r, g, b], -1)
    gray = s == 0
    out[gray] = np.repeat(v[gray][:, None], 3, 1).astype(np.uint8)
    return out


def hue_shift_u8(hue_factor: float) -> int:
    """torchvision F_pil.adjust_hue's H-plane shift: the C-cast of
    hue_factor*255 to uint8 (truncate toward zero, wrap mod 256)."""
    return int(math.trunc(hue_factor * 255)) % 256


def adjust_hue(img: np.ndarray, hue_factor: float) -> np.ndarray:
    """torchvision adjust_hue on PIL: HSV roundtrip + uint8 wraparound
    shift of the H plane (F_pil.adjust_hue)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError(f"hue_factor {hue_factor} not in [-0.5, 0.5]")
    hsv = rgb2hsv(img)
    hsv[..., 0] = ((hsv[..., 0].astype(np.int32) + hue_shift_u8(hue_factor))
                   % 256).astype(np.uint8)
    return hsv2rgb(hsv)


def to_grayscale3(img: np.ndarray) -> np.ndarray:
    """torchvision Grayscale(3): convert("L") replicated to 3 channels."""
    return np.repeat(luma(img)[..., None], 3, axis=-1)


def hflip(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1].copy()


# ----------------------------------------------------------------- geometry
def perspective_source_grid(h: int, w: int, coeffs):
    """(sx, sy, oob): Pillow ImagingGenericTransform's float64 source
    coordinates (+0.5 output centers, -0.5 shift) and its HALF-OPEN
    out-of-bounds mask — a source coord EXACTLY equal to size-0.5 is OOB
    (`xx >= xsize` after the +0.5 shift) while -0.5 itself is in bounds;
    verified against the installed Pillow.

    This is THE load-bearing boundary semantics, shared by every host-side
    consumer (perspective_bilinear here, augment.warp_bilinear_pil_exact
    and the pil-exact label warp on device) so an edge-tie correction
    lands exactly once."""
    a, b, c, d, e, f, g, hh = [float(v) for v in coeffs]
    ys = np.arange(h, dtype=np.float64) + 0.5
    xs = np.arange(w, dtype=np.float64) + 0.5
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    den = g * xx + hh * yy + 1.0
    sx = (a * xx + b * yy + c) / den - 0.5
    sy = (d * xx + e * yy + f) / den - 0.5
    oob = (sx < -0.5) | (sx >= w - 0.5) | (sy < -0.5) | (sy >= h - 0.5)
    return sx, sy, oob


def perspective_bilinear(img: np.ndarray, coeffs, fill: int = 0
                         ) -> np.ndarray:
    """Image.transform(size, PERSPECTIVE, coeffs, BILINEAR, fillcolor):
    per-output-pixel double homography at +0.5 centers, -0.5 shift,
    edge-clamped double bilinear, truncated uint8 store; fill outside
    [-0.5, size-0.5) (ImagingGenericTransform + bilinear filter)."""
    h, w = img.shape[:2]
    sx, sy, oob = perspective_source_grid(h, w, coeffs)
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    wx = sx - x0
    wy = sy - y0
    x0i = np.clip(x0.astype(np.int64), 0, w - 1)
    x1i = np.clip(x0.astype(np.int64) + 1, 0, w - 1)
    y0i = np.clip(y0.astype(np.int64), 0, h - 1)
    y1i = np.clip(y0.astype(np.int64) + 1, 0, h - 1)
    src = img if img.ndim == 3 else img[..., None]
    # gather the 4 taps at uint8 width (8x less traffic than gathering
    # a float64 image) and promote AFTER — identical doubles either way
    # (uint8 -> f64 is exact), ~2x the throughput of the f64-gather form
    wx = wx[..., None]
    wy = wy[..., None]
    top = (src[y0i, x0i].astype(np.float64) * (1 - wx)
           + src[y0i, x1i].astype(np.float64) * wx)
    bot = (src[y1i, x0i].astype(np.float64) * (1 - wx)
           + src[y1i, x1i].astype(np.float64) * wx)
    v = top * (1 - wy) + bot * wy
    out = np.clip(np.trunc(v), 0, 255).astype(np.uint8)
    out[oob] = fill
    if img.ndim == 2:
        out = out[..., 0]
    return out


def pil_rotate_matrix(angle: float, w: int, h: int):
    """The 6-coeff inverse affine Image.rotate(angle, expand=False,
    center=None) builds in Python — including the angle%360 and the
    round(cos, 15) quantization."""
    angle = angle % 360.0
    center = (w / 2, h / 2)
    rad = -math.radians(angle)
    matrix = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
              round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    a, b, _c, d, e, _f = matrix
    matrix[2] = a * -center[0] + b * -center[1]
    matrix[5] = d * -center[0] + e * -center[1]
    matrix[2] += center[0]
    matrix[5] += center[1]
    return matrix


def rotate_fixed_point_starts(angle: float, w: int, h: int):
    """(xin0, yin0, dxx, dyy, dxr, dyr): 16.16 fixed-point start/steps of
    Pillow's NEAREST affine fast path for rotate(angle, expand=False).
    Source index for output (x, y) = (xin0 + y*dxr + x*dxx) >> 16 etc —
    pure integer math, shared with the on-device implementation."""
    a = pil_rotate_matrix(angle, w, h)
    fix = lambda v: int(math.floor(v * 65536.0 + 0.5))  # noqa: E731
    xo = a[2] + a[1] * 0.5 + a[0] * 0.5
    yo = a[5] + a[4] * 0.5 + a[3] * 0.5
    return fix(xo), fix(yo), fix(a[0]), fix(a[3]), fix(a[1]), fix(a[4])


def rotate_nearest(img: np.ndarray, angle: float, fill: int = 0
                   ) -> np.ndarray:
    """Image.rotate(angle, NEAREST, expand=False, fillcolor=fill):
    Geometry.c's 16.16 fixed-point integer path, bit-identical."""
    h, w = img.shape[:2]
    xin0, yin0, dxx, dyy, dxr, dyr = rotate_fixed_point_starts(angle, w, h)
    xs = np.arange(w, dtype=np.int64)
    ys = np.arange(h, dtype=np.int64)
    xin = (xin0 + ys[:, None] * dxr + xs[None, :] * dxx) >> 16
    yin = (yin0 + ys[:, None] * dyr + xs[None, :] * dyy) >> 16
    oob = (xin < 0) | (xin >= w) | (yin < 0) | (yin >= h)
    xi = np.clip(xin, 0, w - 1)
    yi = np.clip(yin, 0, h - 1)
    out = img[yi, xi].copy()
    out[oob] = fill
    return out


# ---------------------------------------------------- composed aug families
def apply_family(img: np.ndarray, aug_type: str, params: dict
                 ) -> np.ndarray:
    """Apply one reference aug menu (GTAV.py:42-46) with EXPLICIT params
    (``host_augment.sample_params``'s schema). Image-only, like the
    reference (GTAV.py:87-89 leaves labels untransformed — SURVEY.md
    section 4 bug 5)."""
    if not params.get("applied", True):
        return img.copy()
    if aug_type == "CS-HF":
        img = adjust_contrast(img, params["contrast"])
        img = adjust_saturation(img, params["saturation"])
        return hflip(img)
    if aug_type == "H-RP":
        img = adjust_hue(img, params["hue"])
        return perspective_bilinear(img, params["coeffs"], fill=0)
    if aug_type == "B-GS-R":
        img = adjust_brightness(img, params["brightness"])
        img = to_grayscale3(img)
        return rotate_nearest(img, params["angle"], fill=0)
    raise ValueError(f"unknown aug_type {aug_type!r}")
