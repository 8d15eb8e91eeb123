"""On-device augmentation: the reference's GTA5 menus, batched over NHWC
float images on the 0-255 scale, on the batch's device.

Counterpart of ``dasemanticsegmentationaml_tpu/data/augment.py``. The
reference augments on the host with torchvision-on-PIL transforms
(reference GTAV.py:32-59), each menu wrapped in RandomApply(p=0.5) (:51):

  CS-HF : ColorJitter(contrast=[2,5]) -> ColorJitter(saturation=[1,3])
          -> RandomHorizontalFlip(p=1)
  H-RP  : ColorJitter(hue=0.2) -> RandomPerspective(p=1, distortion=0.5)
  B-GS-R: ColorJitter(brightness=[1,2]) -> Grayscale(3)
          -> RandomRotation(degrees=90)

Two paths, as in the JAX package:

* training (``sample_params`` + ``apply_params``, together
  ``augment_batch``): every sample's parameters are drawn on the device by
  an explicit ``torch.Generator`` seeded from ``(seed, epoch, it)``
  (``batch_generator``), one draw decides RandomApply for each sample,
  and the menu is applied to the whole batch and selected per sample with
  ``torch.where``, as JAX's vmapped ``lax.cond``. Nothing in it reads a
  value back or copies from host memory, so ``prepare_batch`` still only
  enqueues work. The colour ops follow PIL's float formulation; the
  bilinear gather rounds its rows to bf16 as JAX's ``_gather_bilinear``
  (:261-283) does, which rounds hue-jittered pixels to 2^-8 relative.
  The torch and jax.random streams differ, so the two packages draw other
  realizations; the tests hold the port to JAX by feeding one set of
  parameters to both (``apply_family_with_params(pil_exact=False)``).
* replay (``apply_family_with_params(pil_exact=True)``, one sample, host
  parameters): PIL's integer math (truncating blends, integer luma, the
  integer-rounded contrast mean), the float64 host grid of the
  perspective warp and Pillow's 16.16 fixed-point rotation, so CS-HF and
  B-GS-R equal ``augment_pil_exact.apply_family`` bit for bit and H-RP
  stays within JAX's measured hue and warp envelope.

Not ported, by design: the gather-free 3-shear rotation
(``rotate_nearest_3shear`` :498 and its ``_shift_rows/_cols_nearest``
:442/:474) behind ``--fast_device_geometry``. It exists because the TPU's
gathers are slow; on a GPU a gather is an indexed load.

The reference warps the image only and leaves labels misaligned under
flip, perspective and rotation (GTAV.py:87-89; SURVEY.md section 4 bug
5); ``augment_labels`` mirrors the geometric ops onto the labels with
nearest sampling and the ignore fill 255.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import augment_pil_exact as px

IGNORE_FILL = 255


def _f32(value) -> float:
    """A host factor rounded to float32 (JAX's ``jnp.float32(factor)``),
    kept a Python number so that no host-to-device copy is made."""
    return float(np.float32(value))


def _per_sample(value, img: torch.Tensor):
    """Broadcast a (B,) tensor of per-sample values over a (B, H, W, C)
    batch; a Python number or 0-d tensor is broadcast as it is."""
    if isinstance(value, torch.Tensor):
        return value.view(value.shape + (1,) * (img.dim() - value.dim()))
    return _f32(value)


def _div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` correctly rounded on every device: CUDA divides by
    a host scalar through its reciprocal, which is not always the
    quotient, so the divisor is made on ``x``'s device (a fill, not a
    copy)."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


# ------------------------------------------------------------- colour ops
def rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """ITU-R 601-2 luma in float (JAX :43)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return r * (299 / 1000) + g * (587 / 1000) + b * (114 / 1000)


def pil_luma(img: torch.Tensor) -> torch.Tensor:
    """Pillow convert('L') exactly: (19595 R + 38470 G + 7471 B + 0x8000)
    >> 16 on the integer values of ``img`` (JAX :49)."""
    i = img.to(torch.int32)
    l_int = (i[..., 0] * 19595 + i[..., 1] * 38470 + i[..., 2] * 7471
             + 0x8000) >> 16
    return l_int.to(torch.float32)


def _clip(img: torch.Tensor) -> torch.Tensor:
    return img.clamp(0.0, 255.0)


def _pil_blend(degenerate, img: torch.Tensor, factor) -> torch.Tensor:
    """Image.blend on uint8-valued floats: float32 ``d + f * (img - d)``,
    clipped, truncated (JAX :64)."""
    return torch.trunc(_clip(degenerate + factor * (img - degenerate)))


def adjust_brightness(img, factor, pil_exact: bool = False):
    factor = _per_sample(factor, img)
    if pil_exact:
        return _pil_blend(0.0, img, factor)
    return _clip(img * factor)


def adjust_contrast(img, factor, pil_exact: bool = False):
    """Blend against the mean of the L plane of each image (JAX :81). The
    pil-exact mean is ImageStat's int(mean + 0.5) in int64: (2s+n)//(2n)."""
    factor = _per_sample(factor, img)
    if pil_exact:
        l_int = pil_luma(img).to(torch.int64)
        n = l_int.shape[-1] * l_int.shape[-2]
        s = l_int.sum(dim=(-2, -1))
        mean = ((2 * s + n) // (2 * n)).to(torch.float32)
        return _pil_blend(mean[..., None, None, None], img, factor)
    mean = rgb_to_grayscale(img).mean(dim=(-2, -1))[..., None, None, None]
    return _clip((img - mean) * factor + mean)


def adjust_saturation(img, factor, pil_exact: bool = False):
    factor = _per_sample(factor, img)
    if pil_exact:
        return _pil_blend(pil_luma(img)[..., None], img, factor)
    gray = rgb_to_grayscale(img)[..., None]
    return _clip((img - gray) * factor + gray)


def _pick(sector: torch.Tensor, opts):
    """opts[sector] by a chain of selects (JAX :142)."""
    out = opts[5]
    for k in range(4, -1, -1):
        out = torch.where(sector == k, opts[k], out)
    return out


def adjust_hue(img: torch.Tensor, hue_shift) -> torch.Tensor:
    """Float HSV round trip with the hue turned by ``hue_shift`` (a
    fraction of the circle, per sample; JAX :114)."""
    hue_shift = _per_sample(hue_shift, img[..., 0])
    x = _div(img, 255.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    c = maxc - minc
    safe_c = torch.where(c == 0, 1.0, c)
    rc = (maxc - r) / safe_c
    gc = (maxc - g) / safe_c
    bc = (maxc - b) / safe_c
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(c == 0, 0.0, torch.remainder(_div(h, 6.0), 1.0))
    s = torch.where(maxc == 0, 0.0, c / torch.where(maxc == 0, 1.0, maxc))

    h = torch.remainder(h + hue_shift, 1.0)

    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    out = torch.stack([_pick(i, [v, q, p, p, t, v]),
                       _pick(i, [t, v, v, q, p, p]),
                       _pick(i, [p, p, t, v, v, q])], dim=-1)
    return _clip(out * 255.0)


def adjust_hue_pil(img: torch.Tensor, hue_shift_u8: int) -> torch.Tensor:
    """torchvision-on-PIL adjust_hue's structure in float32 (JAX :154):
    the uint8 HSV planes of Pillow's rgb2hsv, the H plane shifted by an
    integer with uint8 wraparound, Pillow's hsv2rgb with C round(). Equal
    to ``augment_pil_exact.adjust_hue`` but for the float32-against-float64
    quantizer ties JAX measures."""
    i = img.to(torch.int32)
    r, g, b = i[..., 0], i[..., 1], i[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    uv = maxc - minc
    gray = uv == 0
    cr = torch.where(gray, 1, uv).to(torch.float32)
    maxf = torch.where(maxc == 0, 1, maxc).to(torch.float32)
    s_q = torch.floor(uv.to(torch.float32) / maxf * 255.0)
    rc = (maxc - r).to(torch.float32) / cr
    gc = (maxc - g).to(torch.float32) / cr
    bc = (maxc - b).to(torch.float32) / cr
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(_div(h, 6.0) + 1.0, 1.0)
    h_q = torch.where(gray, 0, torch.floor(h * 255.0).to(torch.int32))
    s_q = torch.where(gray, 0.0, s_q)

    h_shifted = torch.remainder(h_q + int(hue_shift_u8), 256)

    # hsv2rgb (Pillow Convert.c): i = floor(h*6/255); p/q/t = round(...),
    # C round() on operands >= 0 is floor(v + 0.5)
    x = _div(h_shifted.to(torch.float32) * 6.0, 255.0)
    sector = torch.remainder(torch.floor(x).to(torch.int32), 6)
    f = x - torch.floor(x)
    fs = _div(s_q, 255.0)
    v = maxc.to(torch.float32)
    p = torch.floor(v * (1.0 - fs) + 0.5)
    q = torch.floor(v * (1.0 - fs * f) + 0.5)
    t = torch.floor(v * (1.0 - fs * (1.0 - f)) + 0.5)
    out = torch.stack([_pick(sector, [v, q, p, p, t, v]),
                       _pick(sector, [t, v, v, q, p, p]),
                       _pick(sector, [p, p, t, v, v, q])], dim=-1)
    return torch.where(gray[..., None], v[..., None], out)


def to_grayscale3(img: torch.Tensor, pil_exact: bool = False) -> torch.Tensor:
    gray = pil_luma(img) if pil_exact else rgb_to_grayscale(img)
    return gray[..., None].expand(*gray.shape, 3)


def hflip(img: torch.Tensor) -> torch.Tensor:
    """Mirror the W axis of (..., H, W, C)."""
    return img.flip(-2)


# -------------------------------------------------------------- geometry
def perspective_coeffs(src_pts: torch.Tensor,
                       dst_pts: torch.Tensor) -> torch.Tensor:
    """(B, 8) coefficients of the homographies mapping dst (x, y) to src
    (x, y), from (B, 4, 2) corner sets (JAX :224, batched): the linear
    system of torchvision's ``_get_perspective_coeffs``, solved in
    float32 by ``solve_ex`` without its error check, which would read a
    value back."""
    x, y = dst_pts[..., 0], dst_pts[..., 1]
    sx, sy = src_pts[..., 0], src_pts[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rows_x = torch.stack([x, y, one, zero, zero, zero, -x * sx, -y * sx], -1)
    rows_y = torch.stack([zero, zero, zero, x, y, one, -x * sy, -y * sy], -1)
    a = torch.stack([rows_x, rows_y], dim=-2).flatten(-3, -2)  # (B, 8, 8)
    b = torch.stack([sx, sy], dim=-1).flatten(-2)              # (B, 8)
    solution, _info = torch.linalg.solve_ex(a, b[..., None],
                                            check_errors=False)
    return solution[..., 0]


def _source_coords(h: int, w: int, coeffs: torch.Tensor):
    """Continuous source coordinates of every output pixel of each image
    (PIL: the inverse map at pixel centres + 0.5, shifted back by 0.5;
    JAX :248). coeffs (B, 8) -> sx, sy (B, h, w)."""
    dev = coeffs.device
    yy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None]
    xx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :]
    a, b, c, d, e, f, g, hh = coeffs[:, :, None, None].unbind(1)
    den = g * xx + hh * yy + 1.0
    sx = (a * xx + b * yy + c) / den - 0.5
    sy = (d * xx + e * yy + f) / den - 0.5
    return sx, sy


def _gather(img: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """out[n, y, x] = img[n].reshape(h * w, C)[flat_idx[n, y, x]]: one
    gather over the whole batch. img (B, h, w, C); flat_idx (B, h, w)."""
    bsz, h, w, ch = img.shape
    base = torch.arange(bsz, device=img.device)[:, None, None] * (h * w)
    return img.reshape(bsz * h * w, ch).index_select(
        0, (flat_idx + base).reshape(-1)).reshape(bsz, h, w, ch)


def _gather_bilinear(img, x0i, y0i, wx, wy) -> torch.Tensor:
    """Blend the four taps at the edge-clamped integer corners with the
    fractional weights (JAX :261). The taps are gathered in bf16, as JAX
    gathers them: exact for uint8-valued pixels, 2^-8 relative for
    hue-jittered ones."""
    _, h, w, _ = img.shape
    f = img.to(torch.bfloat16)
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    taps = [_gather(f, yi * w + xi).float()
            for yi, xi in ((y0i, x0i), (y0i, x1i), (y1i, x0i), (y1i, x1i))]
    wx, wy = wx[..., None], wy[..., None]
    top = taps[0] * (1 - wx) + taps[1] * wx
    bot = taps[2] * (1 - wx) + taps[3] * wx
    return top * (1 - wy) + bot * wy


def warp(img: torch.Tensor, coeffs: torch.Tensor, mode: str = "bilinear",
         fill: float = 0.0) -> torch.Tensor:
    """Inverse-warp (B, H, W, C) images or (B, H, W) label maps by their
    homographies (dst -> src), coeffs (B, 8) (JAX :286). Half-open bounds:
    a source coordinate of exactly size - 0.5 is outside, as in Pillow.
    Nearest rounds half to even as ``jnp.round``; bilinear gives both taps
    of a source column in [-0.5, 0) to pixel 0 (the low-edge clamp)."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[..., None]
    _, h, w, _ = img.shape
    sx, sy = _source_coords(h, w, coeffs)
    oob = (sx < -0.5) | (sx >= w - 0.5) | (sy < -0.5) | (sy >= h - 0.5)
    # clip in float before each integer cast: an out-of-range float cast
    # differs between the CPU and CUDA
    if mode == "nearest":
        ix = torch.round(sx).clamp(0, w - 1).long()
        iy = torch.round(sy).clamp(0, h - 1).long()
        out = _gather(img, iy * w + ix)
    else:
        x0 = torch.floor(sx)
        y0 = torch.floor(sy)
        wx = torch.where(x0 < 0, 0.0, sx - x0)
        wy = torch.where(y0 < 0, 0.0, sy - y0)
        out = _gather_bilinear(img, x0.clamp(0, w - 1).long(),
                               y0.clamp(0, h - 1).long(), wx, wy)
    out = torch.where(oob[..., None], fill, out)
    return out[..., 0] if squeeze else out


def warp_bilinear_pil_exact(img: torch.Tensor, coeffs) -> torch.Tensor:
    """Image.transform(PERSPECTIVE, BILINEAR) replay of one (H, W, C)
    image with host coefficients (JAX :324): the homography, floor and
    bounds in float64 on the host (``augment_pil_exact.
    perspective_source_grid``), the gather and blend on the device, the
    store truncated as Pillow's."""
    h, w = img.shape[:2]
    sx, sy, oob = px.perspective_source_grid(h, w, coeffs)
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    wx = np.where(x0 < 0, 0.0, sx - x0).astype(np.float32)
    wy = np.where(y0 < 0, 0.0, sy - y0).astype(np.float32)
    x0i = np.clip(x0, 0, w - 1).astype(np.int64)
    y0i = np.clip(y0, 0, h - 1).astype(np.int64)
    dev = img.device
    grid = [torch.from_numpy(a[None]).to(dev) for a in (x0i, y0i, wx, wy)]
    out = torch.trunc(_clip(_gather_bilinear(img[None], *grid)[0]))
    return torch.where(torch.from_numpy(oob).to(dev)[..., None], 0.0, out)


def warp_nearest_pil_exact(label: torch.Tensor, coeffs,
                           fill: float = 0.0) -> torch.Tensor:
    """NEAREST warp of an (H, W) label map on the same float64 host grid
    as ``warp_bilinear_pil_exact`` (JAX :357): index floor(s + 0.5), the
    shared half-open mask."""
    h, w = label.shape
    sx, sy, oob = px.perspective_source_grid(h, w, coeffs)
    xi = np.clip(np.floor(sx + 0.5), 0, w - 1).astype(np.int64)
    yi = np.clip(np.floor(sy + 0.5), 0, h - 1).astype(np.int64)
    dev = label.device
    out = _gather(label[None, ..., None],
                  torch.from_numpy((yi * w + xi)[None]).to(dev))[0, ..., 0]
    return torch.where(torch.from_numpy(oob).to(dev), fill, out)


def rotation_coeffs(angle_deg: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 8) homographies of PIL's rotate(angle, expand=False): a counter-
    clockwise turn about (w/2, h/2) (JAX :379)."""
    theta = _div(angle_deg * math.pi, 180.0)
    cos, sin = torch.cos(theta), torch.sin(theta)
    cx, cy = w * 0.5, h * 0.5
    zero = torch.zeros_like(cos)
    return torch.stack([cos, -sin, cx - cx * cos + cy * sin,
                        sin, cos, cy - cx * sin - cy * cos, zero, zero], -1)


def rotate_nearest_pil_exact(img: torch.Tensor, angle: float,
                             fill: float = 0.0) -> torch.Tensor:
    """PIL Image.rotate(angle, NEAREST, expand=False) bit for bit on one
    (H, W[, C]) image (JAX :397): Pillow's 16.16 fixed-point walk
    (``augment_pil_exact.rotate_fixed_point_starts``) in int64, so it
    needs no overflow guard and equals the host twin everywhere."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    xin0, yin0, dxx, dyy, dxr, dyr = px.rotate_fixed_point_starts(
        float(angle), w, h)
    xs = torch.arange(w, dtype=torch.int64, device=img.device)[None, :]
    ys = torch.arange(h, dtype=torch.int64, device=img.device)[:, None]
    xin = (xin0 + ys * dxr + xs * dxx) >> 16
    yin = (yin0 + ys * dyr + xs * dyy) >> 16
    oob = (xin < 0) | (xin >= w) | (yin < 0) | (yin >= h)
    out = _gather(img[None], (yin.clamp(0, h - 1) * w
                              + xin.clamp(0, w - 1))[None])[0]
    out = torch.where(oob[..., None], fill, out)
    return out[..., 0] if squeeze else out


# ------------------------------------------------------------- sampling
def batch_generator(seed: int, epoch: int, it: int,
                    device) -> torch.Generator:
    """The generator of batch ``it`` of ``epoch``, on ``device``: seeded
    from ``(seed, epoch, it)`` through numpy's SeedSequence, as JAX folds
    epoch and step into its key (cli.py:425)."""
    hi, lo = np.random.SeedSequence(
        (int(seed), int(epoch), int(it))).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(hi) << 32) | int(lo))
    return gen


def sample_perspective_endpoints(batch: int, h: int, w: int,
                                 generator: torch.Generator,
                                 distortion: float = 0.5):
    """torchvision RandomPerspective.get_params' integer corners for each
    sample (JAX :564): (start, end), each (B, 4, 2) float32 (x, y),
    corners in the order top-left, top-right, bottom-right, bottom-left."""
    half_h, half_w = h // 2, w // 2
    dh = int(distortion * half_h)
    dw = int(distortion * half_w)
    dev = generator.device

    def ri(lo, hi):
        return torch.randint(lo, hi, (batch,), generator=generator,
                             device=dev).float()

    end = torch.stack([
        torch.stack([ri(0, dw + 1), ri(0, dh + 1)], -1),
        torch.stack([ri(w - dw - 1, w), ri(0, dh + 1)], -1),
        torch.stack([ri(w - dw - 1, w), ri(h - dh - 1, h)], -1),
        torch.stack([ri(0, dw + 1), ri(h - dh - 1, h)], -1)], dim=1)
    # filled in place: a tensor made from host values would be a copy
    # that waits for the stream
    start = torch.zeros(batch, 4, 2, device=dev)
    start[:, 1:3, 0] = w - 1.0
    start[:, 2:4, 1] = h - 1.0
    return start, end


def sample_params(aug_type: str, batch: int, h: int, w: int,
                  generator: torch.Generator,
                  apply_prob: float = 0.5) -> dict:
    """Per-sample parameters of one menu, drawn on the generator's device
    (JAX ``_aug_cs_hf`` :583, ``_aug_h_rp`` :595, ``_aug_b_gs_r`` :610):
    ``applied`` (B,) bool, one uniform draw each against ``apply_prob``;
    CS-HF ``contrast`` U[2, 5), ``saturation`` U[1, 3); H-RP ``hue``
    U[-0.2, 0.2), ``start``/``end`` corners and their ``coeffs`` (B, 8);
    B-GS-R ``brightness`` U[1, 2), ``angle`` U[-90, 90) degrees."""
    dev = generator.device

    def uniform(lo, hi):
        return torch.empty(batch, device=dev).uniform_(lo, hi,
                                                       generator=generator)

    params = {"applied": torch.rand(batch, generator=generator,
                                    device=dev) < apply_prob}
    if aug_type == "CS-HF":
        params["contrast"] = uniform(2.0, 5.0)
        params["saturation"] = uniform(1.0, 3.0)
    elif aug_type == "H-RP":
        params["hue"] = uniform(-0.2, 0.2)
        start, end = sample_perspective_endpoints(batch, h, w, generator)
        params.update(start=start, end=end,
                      coeffs=perspective_coeffs(start, end))
    elif aug_type == "B-GS-R":
        params["brightness"] = uniform(1.0, 2.0)
        params["angle"] = uniform(-90.0, 90.0)
    else:
        raise ValueError(f"unknown aug_type {aug_type!r}")
    return params


# ----------------------------------------------------- composed families
def apply_params(imgs: torch.Tensor, labels: torch.Tensor, aug_type: str,
                 params: dict, augment_labels: bool = False):
    """One menu on a batch with explicit per-sample parameters
    (``sample_params``' schema): imgs (B, H, W, 3) float on the 0-255
    scale, labels (B, H, W). Every sample is augmented and the result
    kept where ``params['applied']``, as JAX's vmapped ``lax.cond``
    (:731-741)."""
    h, w = imgs.shape[1:3]
    lab = labels
    if aug_type == "CS-HF":
        out = adjust_contrast(imgs, params["contrast"])
        out = adjust_saturation(out, params["saturation"])
        out = hflip(out)
        if augment_labels:
            lab = labels.flip(-1)
    elif aug_type in ("H-RP", "B-GS-R"):
        if aug_type == "H-RP":
            out = adjust_hue(imgs, params["hue"])
            coeffs, mode = params["coeffs"], "bilinear"
        else:
            out = to_grayscale3(adjust_brightness(imgs,
                                                  params["brightness"]))
            coeffs, mode = rotation_coeffs(params["angle"], h, w), "nearest"
        out = warp(out, coeffs, mode=mode, fill=0.0)
        if augment_labels:
            lab = warp(labels, coeffs, mode="nearest", fill=IGNORE_FILL)
    else:
        raise ValueError(f"unknown aug_type {aug_type!r}")
    applied = params["applied"]
    imgs = torch.where(applied[:, None, None, None], out, imgs)
    if augment_labels:
        labels = torch.where(applied[:, None, None], lab, labels)
    return imgs, labels


def augment_batch(imgs: torch.Tensor, labels: torch.Tensor,
                  aug_type: Optional[str], generator: torch.Generator,
                  augment_labels: bool = False, apply_prob: float = 0.5,
                  rows: Optional[Tuple[int, int]] = None):
    """RandomApply(p=0.5)-wrapped menu on every sample of a batch, with
    parameters drawn by ``generator`` (JAX :744). ``rows`` = (start,
    global batch): the batch is rows ``[start, start + B)`` of a global
    batch (a data-parallel rank's slice), and takes those rows' draws of
    the global batch's, as JAX augments the global batch from one key
    (cli.py:404-430)."""
    if aug_type is None:
        return imgs, labels
    bsz, h, w = imgs.shape[:3]
    start, total = rows if rows is not None else (0, bsz)
    params = sample_params(aug_type, total, h, w, generator, apply_prob)
    if rows is not None:
        params = {k: v[start:start + bsz] for k, v in params.items()}
    return apply_params(imgs, labels, aug_type, params, augment_labels)


def apply_family_with_params(img: torch.Tensor, label: torch.Tensor,
                             aug_type: str, params: dict,
                             augment_labels: bool = False,
                             pil_exact: bool = True):
    """One menu on one sample, img (H, W, 3) float with uint8 values,
    label (H, W), with host parameters in ``host_augment.sample_params``'
    schema (JAX :645). ``pil_exact`` routes the colour ops through PIL's
    integer semantics, the warp through the float64 host grid and the
    rotation through the fixed-point walk; otherwise the training path
    (``apply_params``) runs on a batch of one."""
    if not params.get("applied", True):
        return img, label
    if not pil_exact:
        dev = img.device
        one = {k: torch.tensor([params[k]], dtype=torch.float32, device=dev)
               for k in ("contrast", "saturation", "hue", "brightness",
                         "angle", "coeffs") if k in params}
        one["applied"] = torch.ones(1, dtype=torch.bool, device=dev)
        imgs, labels = apply_params(img[None], label[None], aug_type, one,
                                    augment_labels)
        return imgs[0], labels[0]
    if aug_type == "CS-HF":
        img = adjust_contrast(img, params["contrast"], pil_exact=True)
        img = adjust_saturation(img, params["saturation"], pil_exact=True)
        if augment_labels:
            label = label.flip(-1)
        return hflip(img), label
    if aug_type == "H-RP":
        img = adjust_hue_pil(img, px.hue_shift_u8(params["hue"]))
        img = warp_bilinear_pil_exact(img, params["coeffs"])
        if augment_labels:
            # the image's float64 grid: a float32 one would put labels a
            # pixel off the image where floor() flips (~1% of pixels)
            label = warp_nearest_pil_exact(label, params["coeffs"],
                                           fill=IGNORE_FILL)
        return img, label
    if aug_type == "B-GS-R":
        img = adjust_brightness(img, params["brightness"], pil_exact=True)
        img = to_grayscale3(img, pil_exact=True)
        img = rotate_nearest_pil_exact(img, params["angle"], fill=0.0)
        if augment_labels:
            label = rotate_nearest_pil_exact(label, params["angle"],
                                             fill=IGNORE_FILL)
        return img, label
    raise ValueError(f"unknown aug_type {aug_type!r}")
