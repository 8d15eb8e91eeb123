"""Opt-in int8 post-training quantization (PTQ) of the inference path.

Counterpart of ``dasemanticsegmentationaml_tpu/ops/quantize.py``: the
same symmetric scheme, on the port's modules.

* weights: BN folded into the conv (``ops/norm.py::fold_bn_into_conv``),
  then per output channel ``w_int8 = clip(round(w / w_scale), +-127)``
  with ``w_scale[c] = absmax(w[c]) / 127`` (JAX :92);
* activations: one scale a tensor, ``absmax / 127`` over calibration
  batches run in eval mode (or the 99.9th percentile, ``clip="p999"``);
* conv: s8 x s8 -> s32, then ``acc * (in_scale * w_scale[c]) + bias[c]``
  and ReLU in fp32, cast to the dtype the fp block would have produced
  (``int8_conv_epilogue``: the CUDA kernel ``csrc/int8_conv.cu`` on the
  card, its plain version on the CPU).

Only the conv+BN+ReLU blocks quantize (``QuantBlock``: ``ConvX`` and
``ConvBNReLU``); depthwise convs, attention gates, classifiers and pools
stay in fp. A block's ``quant_mode`` is "off" (the default, which changes
no parameter, buffer or state-dict name), "calib" (records its input's
absmax and 99.9th percentile in eval mode) or "int8" (inference only; runs
``int8_conv_epilogue`` from its ``quant`` entry; an entry marked disabled
by ``filter_fn`` runs the fp path; no entry raises). The JAX module keeps
the records and entries in flax collections; here a block holds its own
(``calib``, ``quant``: plain attributes, never in the state dict), and
the collection is a dict by module name.

Workflow (JAX :20-26)::

    qmodel, quant = quantize_model(model, batches, filter_fn=...,
                                   clip="absmax")
    logits = qmodel(x)
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# quantize_activation is JAX ops/quantize.py:102's counterpart, kept
# beside the kernel's plain version, which calls it
from .cuda.int8_conv import (int8_conv, pack_weights,  # noqa: F401
                             quantize_activation)
from .norm import fold_bn_into_conv

_MODES = ("off", "calib", "int8")
#: the p999 record's subsample cap: about 2^20 elements (JAX :175-178)
_SAMPLE = 1 << 20

_HIGHRES = {"0", "1", "2", "3"}


def _backbone_stage(p) -> Optional[str]:
    """The index of ``cp.backbone.features.<i>`` in the module path ``p``
    (JAX's ``features_<i>``), or None."""
    if len(p) > 3 and p[:3] == ("cp", "backbone", "features"):
        return p[3]
    return None


#: JAX :64-78's presets, restated on the port's module paths (a tuple of
#: the parts of ``named_modules()``'s name): JAX ("conv_out", "conv") is
#: the port's ``conv_out.conv``, ("cp", "conv_head16") ``cp.conv_head16``,
#: ("cp", "backbone", "features_0") ``cp.backbone.features.0``. Chosen on a
#: TPU; the port keeps them as they are until trained weights let the card
#: choose (ROADMAP.md).
PRESET_FILTERS: Dict[str, Optional[Callable]] = {
    "all": None,
    "head": lambda p: p[0] == "conv_out",
    "heads_cp": lambda p: not (p[0] == "cp" and p[1] == "backbone"),
    "backbone": lambda p: p[0] == "cp" and p[1] == "backbone",
    "deep": lambda p: not (p[0] == "cp" and p[1] == "backbone"
                           and _backbone_stage(p) in _HIGHRES),
    "head_ch": lambda p: p[0] == "conv_out" or (
        p[0] == "cp" and p[1] in ("conv_head16", "conv_head32")),
    "head_ffm": lambda p: p[0] in ("conv_out", "ffm"),
    "head_stem": lambda p: p[0] == "conv_out" or (
        _backbone_stage(p) in ("0", "1")),
}


def check_quant_mode(mode: str) -> str:
    if mode not in _MODES:
        raise ValueError(f"quant_mode must be one of {_MODES}, got {mode!r}")
    return mode


def quantize_weights_per_channel(
        weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW fp weights -> (int8 weights, fp32 scale per output channel)
    (JAX :92-99)."""
    wf = weight.float()
    absmax = wf.abs().amax(dim=tuple(range(1, wf.dim())))
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    per_row = scale.view((-1,) + (1,) * (wf.dim() - 1))
    q = torch.clamp(torch.round(wf / per_row), -127, 127).to(torch.int8)
    return q, scale


def int8_conv_epilogue(x: torch.Tensor, quant: Dict[str, torch.Tensor],
                       stride: int, padding, relu: bool = True,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Quantize ``x``, run the s8 x s8 -> s32 conv, apply the fp32
    scale/bias(/ReLU) epilogue and cast to ``dtype`` (JAX :108-128).
    ``quant``: ``w_int8`` (OIHW), ``w_packed`` (the kernel's rows),
    ``out_mul`` and ``bias`` (fp32, per output channel; BN folded),
    ``in_inv_scale`` (fp32 scalar). ``padding``: an ``int``, or ``(pad_h,
    pad_w)`` (a band of the height-sharded mesh: ``pad_h = 0``)."""
    return int8_conv(x.contiguous(), quant["w_int8"], quant["w_packed"],
                     quant["out_mul"], quant["bias"], quant["in_inv_scale"],
                     stride, padding, relu, dtype)


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the fp block's conv would produce from ``x``: autocast's
    when it is on for ``x``'s device, else ``x``'s."""
    device_type = x.device.type
    if torch.is_autocast_enabled(device_type):
        return torch.get_autocast_dtype(device_type)
    return x.dtype


def record_input_absmax(block: "QuantBlock", x: torch.Tensor) -> None:
    """'calib' mode: keep max|x| and its 99.9th percentile, each maxed over
    batches, on the block (JAX :164-189). The percentile is taken of a
    strided subsample of about 2^20 elements of ``|x|`` in JAX's NHWC ravel
    order, the stride made coprime to the channels so that every channel
    is sampled; ``torch.quantile``'s linear rule is ``jnp.quantile``'s."""
    flat = x.detach().float().abs().permute(0, 2, 3, 1).reshape(-1)
    stride = max(1, flat.numel() // _SAMPLE)
    channels = x.shape[1]
    while channels > 1 and math.gcd(stride, channels) != 1:
        stride += 1
    absmax = flat.max()
    p999 = torch.quantile(flat[::stride], 0.999, interpolation="linear")
    if block.calib is None:
        block.calib = {"in_absmax": absmax, "in_p999": p999}
    else:
        block.calib = {
            "in_absmax": torch.maximum(block.calib["in_absmax"], absmax),
            "in_p999": torch.maximum(block.calib["in_p999"], p999)}


class QuantBlock(nn.Module):
    """A conv (no bias) + BN + ReLU block with the quantization modes (JAX
    stdcnet.py:114-137, bisenet.py:45-76). Subclasses set ``conv`` and
    ``bn``. The mode and the records are plain attributes: "off" leaves
    the parameters, buffers and state-dict names as they were."""

    quant_mode: str = "off"
    #: 'calib': {'in_absmax', 'in_p999'}; 'int8': the block's entry of the
    #: quant collection, {'disabled'} when ``filter_fn`` left it in fp
    calib: Optional[Dict[str, torch.Tensor]] = None
    quant: Optional[Dict[str, torch.Tensor]] = None
    #: the height-sharded mesh (``parallel/spatial.py::SpatialMesh.
    #: convert`` sets it on an int8 block)
    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant_mode == "int8":
            if self.training:
                raise ValueError("int8 quant_mode is inference-only")
            if self.quant is None:
                raise ValueError(
                    "int8 block has no quant entry; run quantize_model "
                    "(collect_calibration + build_quant_collection) first")
            if "disabled" not in self.quant:
                return self._int8_forward(x)
        elif self.quant_mode == "calib" and not self.training:
            record_input_absmax(self, x)
        return F.relu(self.bn(self.conv(x)))

    def _int8_forward(self, x: torch.Tensor) -> torch.Tensor:
        """``int8_conv_epilogue`` of ``x``. Inside the mesh's
        ``banded()``, ``x`` is this rank's band: the block fetches the
        rows its output band reads (``SpatialMesh.conv_window``: the
        halo, zeros outside the image, exchanged in ``x``'s dtype) and
        convolves them with no row padding; the int8 sums are exact and
        the epilogue elementwise, so the band is the whole block's rows
        bit for bit (XLA partitions JAX :108 by height alike). A 1×1 s1
        block reads no halo and takes its input as it comes (a band, or
        the context path's replicated (B, C, 1, 1) mean). The mesh is the
        block's, or its ``conv``'s where the model was converted before it
        was quantized."""
        conv = self.conv
        padding = conv.padding[0]
        mesh = self.mesh if self.mesh is not None else getattr(
            conv, "mesh", None)
        halo = (conv.kernel_size[0], conv.stride[0], padding) != (1, 1, 0)
        if mesh is not None and mesh.active and halo:
            x, _ = mesh.conv_window(conv, x, mesh.even_rows(x))
            padding = (0, conv.padding[1])
        return int8_conv_epilogue(x, self.quant, stride=conv.stride[0],
                                  padding=padding, relu=True,
                                  dtype=_compute_dtype(x))


def quant_blocks(model: nn.Module):
    """(name, block) of every ``QuantBlock`` in ``model``."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, QuantBlock)]


def set_quant_mode(model: nn.Module, mode: str) -> nn.Module:
    check_quant_mode(mode)
    for _, block in quant_blocks(model):
        block.quant_mode = mode
    return model


def collect_calibration(model: nn.Module, batches: Iterable[torch.Tensor],
                        amp_dtype: Optional[torch.dtype] = None
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Run eval-mode forwards over ``batches`` in 'calib' mode and return
    the records by block name, maxed over batches (JAX :204-225). The
    whole forward runs (``model(x)``, JAX's ``method=None``): all three
    heads of a BiSeNet, so the auxiliary heads' blocks get records too.
    ``amp_dtype``: under ``torch.autocast``, as evaluation runs. The
    model's modes and training flag are restored after."""
    blocks = quant_blocks(model)
    modes = [(b, b.quant_mode, b.calib) for _, b in blocks]
    was_training = model.training
    model.eval()
    try:
        for _, b in blocks:
            b.quant_mode, b.calib = "calib", None
        seen = False
        with torch.inference_mode():
            for x in batches:
                with (torch.autocast(x.device.type, dtype=amp_dtype)
                      if amp_dtype is not None else contextlib.nullcontext()):
                    model(x)
                seen = True
        if not seen:
            raise ValueError("collect_calibration needs at least one batch")
        return {name: b.calib for name, b in blocks if b.calib is not None}
    finally:
        for b, mode, calib in modes:
            b.quant_mode, b.calib = mode, calib
        model.train(was_training)


def build_quant_collection(model: nn.Module,
                           calib: Dict[str, Dict[str, torch.Tensor]],
                           filter_fn=None, clip: str = "absmax"
                           ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Fold BN, quantize the weights and combine them with the calibrated
    activation scales, for exactly the blocks with a record (JAX
    :228-281). ``filter_fn(path)``, ``path`` the block's name split at the
    dots: a block it excludes gets ``{'disabled'}`` and runs in fp.
    ``clip``: 'absmax', or 'p999' (the percentile's scale; where a sparse
    input's percentile is 0 the absmax, JAX :256-262)."""
    if clip not in ("absmax", "p999"):
        raise ValueError(f"clip must be 'absmax' or 'p999', got {clip!r}")
    modules = dict(model.named_modules())
    out = {}
    with torch.no_grad():
        for name, rec in calib.items():
            absmax = rec["in_absmax"]
            if clip == "p999":
                p999 = rec["in_p999"]
                absmax = torch.where(p999 > 0, p999, absmax)
            if filter_fn is not None and not filter_fn(tuple(name.split("."))):
                out[name] = {"disabled": torch.zeros((), dtype=torch.int8)}
                continue
            block = modules[name]
            bn = block.bn
            weight, bias = fold_bn_into_conv(
                block.conv.weight.detach().float(), None, bn.weight.float(),
                bn.bias.float(), bn.running_mean.float(),
                bn.running_var.float(), eps=bn.eps)
            w_int8, w_scale = quantize_weights_per_channel(weight)
            in_scale = torch.clamp(absmax.float(), min=1e-12) / 127.0
            out[name] = {
                "w_int8": w_int8,
                "w_packed": pack_weights(w_int8),
                "out_mul": (in_scale * w_scale).float().contiguous(),
                "bias": bias.float().contiguous(),
                "in_inv_scale": (1.0 / in_scale).float().reshape(())}
    if not out:
        raise ValueError("the calibration holds no records")
    return out


def quantize_model(model: nn.Module, batches: Iterable[torch.Tensor],
                   filter_fn=None, clip: str = "absmax",
                   amp_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[nn.Module, Dict[str, Dict[str, torch.Tensor]]]:
    """One-call PTQ (JAX :284-296): calibrate on ``batches`` (eval mode),
    build the collection, and return (a copy of ``model`` in 'int8' mode
    holding its entries, the collection). ``model`` is left as it was."""
    calib = collect_calibration(model, batches, amp_dtype=amp_dtype)
    quant = build_quant_collection(model, calib, filter_fn=filter_fn,
                                   clip=clip)
    qmodel = copy.deepcopy(model).eval()
    for name, block in quant_blocks(qmodel):
        block.quant_mode = "int8"
        block.quant = quant.get(name)
    return qmodel, quant
