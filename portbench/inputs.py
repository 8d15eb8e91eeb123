"""Everything a run feeds both sides, made from ``--seed``.

* ``g_state``: initial weights as a state dict, drawn on ``device`` by a
  ``torch.Generator`` there in a few large calls (one normal and one
  uniform draw, split into the leaves): the convs He-normal, BN's affine
  and statistics near identity but not equal to it. The program and the
  reference load the same dict.
* ``batches``: the traffic's pool of distinct batches, made on the
  device and copied to pinned host memory. Images are uint8 NHWC:
  smooth random colour fields (a coarse normal draw upsampled) with
  noise. Labels are piecewise constant: one class a ``cell`` x ``cell``
  square, and exactly ``round(ignore_share * squares)`` squares of each
  image ignored, at places drawn from the seed, so every seed has the
  same number of valid pixels: trainIds, 255 ignored.

The seed is any integer (the driver's exceed 32 bits); each purpose
(the weights, a pool) draws from its own stream of it.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

def stream_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed of ``purpose``'s stream of ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, purpose))


def _fan_in(shape) -> int:
    return math.prod(shape[1:])


def _split(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    sizes = [math.prod(s) for s in shapes]
    return [t.view(s) for t, s in zip(flat.split(sizes), shapes)]


def g_state(shapes: Dict[str, Tuple[int, ...]], seed: int,
            device) -> Dict[str, torch.Tensor]:
    """G's state dict for ``shapes`` ({key: shape}, the model's
    ``state_dict`` order)."""
    gen = generator(seed, "g", device)
    normal = [k for k, s in shapes.items()
              if not k.endswith(("running_var", "num_batches_tracked"))]
    draws = _split(torch.randn(sum(math.prod(shapes[k]) for k in normal),
                               generator=gen, device=device),
                   [shapes[k] for k in normal])
    var_keys = [k for k in shapes if k.endswith("running_var")]
    var = _split(torch.rand(sum(math.prod(shapes[k]) for k in var_keys),
                            generator=gen, device=device) + 0.5,
                 [shapes[k] for k in var_keys])
    state = dict(zip(var_keys, var))
    for k, t in zip(normal, draws):
        if len(shapes[k]) > 1:  # a conv or linear weight: He-normal
            state[k] = t * math.sqrt(2.0 / _fan_in(shapes[k]))
        elif k.endswith("weight"):  # BN scale
            state[k] = t * 0.1 + 1.0
        else:  # BN shift and running mean
            state[k] = t * 0.1
    for k in shapes:
        if k.endswith("num_batches_tracked"):
            state[k] = torch.zeros((), dtype=torch.long, device=device)
    return {k: state[k] for k in shapes}


def images(n: int, hw: Tuple[int, int], gen: torch.Generator,
           device) -> torch.Tensor:
    """``n`` uint8 NHWC images of size ``hw``."""
    h, w = hw
    coarse = torch.randn((n, 3, max(1, h // 32), max(1, w // 32)),
                         generator=gen, device=device)
    smooth = F.interpolate(coarse, size=hw, mode="bilinear",
                           align_corners=False)
    noise = torch.randn((n, 3, h, w), generator=gen, device=device)
    x = (smooth * 48.0 + noise * 12.0 + 118.0).clamp_(0, 255)
    return x.to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def labels(n: int, hw: Tuple[int, int], cell: int, ignore_share: float,
           gen: torch.Generator, device) -> torch.Tensor:
    """``n`` uint8 label maps of size ``hw`` (module docstring)."""
    h, w = hw
    gh, gw = -(-h // cell), -(-w // cell)
    cls = torch.randint(0, 19, (n, gh * gw), generator=gen, device=device)
    n_ignored = round(ignore_share * gh * gw)
    order = torch.rand((n, gh * gw), generator=gen, device=device).argsort(1)
    ignored = torch.zeros_like(cls, dtype=torch.bool).scatter_(
        1, order[:, :n_ignored], True)
    cls = torch.where(ignored, 255, cls)
    grid = cls.view(n, gh, gw).to(torch.uint8)
    full = grid.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    return full[:, :h, :w].contiguous()


def valid_pixels(hw: Tuple[int, int], cell: int, ignore_share: float) -> int:
    """Valid pixels of one label map (the same for every seed)."""
    h, w = hw
    gh, gw = -(-h // cell), -(-w // cell)
    n_ignored = round(ignore_share * gh * gw)
    # the ignored squares' area inside the map depends on where they lie
    # only where the map's size is not a multiple of the square
    if h % cell or w % cell:
        raise ValueError(f"{hw} is not a multiple of the {cell}-pixel square")
    return h * w - n_ignored * cell * cell


def to_pinned(t: torch.Tensor) -> torch.Tensor:
    if t.device.type != "cuda":
        return t.contiguous()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def pool(seed: int, purpose: str, n_batches: int, batch: int,
         hw: Tuple[int, int], device, *, cell: int = 32,
         ignore_share: float = 0.1):
    """``n_batches`` distinct batches [(images, labels)] in pinned host
    memory (on the CPU: plain host tensors)."""
    gen = generator(seed, purpose, device)
    out = []
    for _ in range(n_batches):
        imgs = images(batch, hw, gen, device)
        labs = labels(batch, hw, cell, ignore_share, gen, device)
        out.append((to_pinned(imgs), to_pinned(labs)))
    return out
