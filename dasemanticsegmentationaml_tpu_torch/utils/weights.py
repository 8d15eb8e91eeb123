"""Reference-named state dicts into the port's modules.

Counterpart of the loading half of ``dasemanticsegmentationaml_tpu/utils/
torch_io.py``. The port's modules carry the reference's attribute names,
so a reference ``.pth`` (or the dict that the JAX package's
``variables_to_torch_state``, torch_io.py:590, produces) loads after two
clean-ups: ``module.`` prefixes go (torch_io.py:498) and the reference's
stage-view duplicates ``x2`` ... ``x32`` (``_DUPLICATE_VIEWS``,
torch_io.py:495) and ``num_batches_tracked`` are dropped. Files are read
with ``torch.load(weights_only=True)``, which reads the zip format that
torch_io.py:457 writes, so the port needs no pickle code of its own.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Union

import numpy as np
import torch
import torch.nn as nn

_DUPLICATE_VIEWS = ("x2", "x4", "x8", "x16", "x32")

Array = Union[np.ndarray, torch.Tensor]


def strip_module_prefix(key: str) -> str:
    while key.startswith("module."):
        key = key[len("module."):]
    return key


def _clean(state: Mapping[str, Array]) -> Dict[str, torch.Tensor]:
    out = {}
    for key, value in state.items():
        key = strip_module_prefix(key)
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        if any(p in _DUPLICATE_VIEWS for p in parts[:-1]):
            continue
        out[key] = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.array(value))
    return out


def load_reference_state(model: nn.Module, state: Mapping[str, Array],
                         strict: bool = True) -> List[str]:
    """Copy a reference-named state dict into ``model``; returns the keys
    loaded.

    strict: every parameter and buffer of the model (except
    ``num_batches_tracked``) must be present with its shape, and no other
    key may be. Non-strict follows the reference's dict-update load
    (stdcnet.py:149-153, model_stages.py:253-258): keys the model lacks,
    or whose shape differs, are skipped."""
    state = _clean(state)
    own = {k: v for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    matched = {k: v for k, v in state.items()
               if k in own and tuple(v.shape) == tuple(own[k].shape)}
    if strict:
        missing = sorted(set(own) - set(state))
        unexpected = sorted(set(state) - set(own))
        bad_shape = sorted(k for k in state if k in own and k not in matched)
        if missing or unexpected or bad_shape:
            raise ValueError(
                f"strict load failed: missing {missing[:8]} "
                f"({len(missing)}), unexpected {unexpected[:8]} "
                f"({len(unexpected)}), shape mismatch {bad_shape[:8]}")
    with torch.no_grad():
        for key, value in matched.items():
            own[key].copy_(value.to(own[key].dtype))
    return list(matched)


def load_pretrain(model: nn.Module, path: str) -> nn.Module:
    """``--pretrain_path`` dispatch (JAX cli.py:45-84): a full network iff
    ``.pth`` is in the path; the ImageNet backbone under ``cp.backbone.``
    iff ``STDCNet`` is in the path and ``.pth`` is not (reference
    stdcnet.py:141-144, model_stages.py:224-227)."""
    if not path:
        return model
    if ".pth" not in path and "STDCNet" not in path:
        print(f"--pretrain_path {path}: matches neither the 'STDCNet' "
              f"backbone rule nor '.pth' — NOT loaded (the reference "
              f"would random-init too, stdcnet.py:141-144)")
        return model
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise SystemExit(f"--pretrain_path {path}: not a state dict")
    if ".pth" in path:
        loaded = load_reference_state(model, obj, strict=False)
        print(f"i'm using pre-trained net: {path} ({len(loaded)} tensors)")
        kind = "the model"
    else:
        prefixed = {f"cp.backbone.{strip_module_prefix(k)}": v
                    for k, v in obj.items()}
        loaded = load_reference_state(model, prefixed, strict=False)
        print(f"i'm using pre-trained: {path} ({len(loaded)} tensors)")
        kind = "the backbone namespace"
    if not loaded:
        raise SystemExit(f"--pretrain_path {path}: ZERO tensors matched "
                         f"{kind} — wrong checkpoint kind?")
    return model


def load_pretrain_discriminator(model: nn.Module, path: str) -> nn.Module:
    """``--d_pretrain_path`` (JAX cli.py:639-649): a non-strict load whose
    every key must name a tensor of this discriminator with its shape, so
    that a checkpoint of another kind (``--depthwise`` / ``--batch_norm``)
    stops the run instead of loading nothing. ``module.`` prefixes go."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise SystemExit(f"--d_pretrain_path {path}: not a state dict")
    state = _clean(obj)
    own = {k: v for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    not_in_model = sorted(k for k in state if k not in own)
    mismatched = sorted((k, tuple(v.shape), tuple(own[k].shape))
                        for k, v in state.items()
                        if k in own and tuple(v.shape) != tuple(own[k].shape))
    if not_in_model or mismatched:
        raise SystemExit(
            f"--d_pretrain_path {path}: keys not in this discriminator "
            f"{not_in_model} / shape mismatches {mismatched} — check "
            "--depthwise/--batch_norm match the checkpoint")
    load_reference_state(model, state, strict=False)
    return model
