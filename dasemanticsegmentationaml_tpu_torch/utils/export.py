"""Serving artifacts of the eval forward (``torch.export``).

Counterpart of ``dasemanticsegmentationaml_tpu/utils/export.py`` for one
device. ``export_inference`` freezes a model, its weights and the eval
hot path (uint8 -> ImageNet normalisation -> BiSeNet -> upsample + argmax
-> int32 trainIds) into a ``torch.export`` program saved as one ``.pt2``
file, with a symbolic batch so that one artifact serves any batch size
(JAX :76). The serving host (``serve.py``) replays it without this
package's model code: the fused upsample+argmax kernel, and the int8
conv kernels of a model returned by ``ops/quantize.py::quantize_model``,
are custom ops (``dseg::upsample_argmax``, ``dseg::int8_conv``) that stay
single nodes of the saved graph, so the artifact carries them as the JAX
one carries the Pallas kernel's Mosaic custom call (JAX :61-69). Loading
one needs the two modules that register the ops (``ops/cuda/
upsample_argmax.py``, ``ops/cuda/int8_conv.py``), nothing of ``models/``.

An artifact runs on the device type it was exported on: the weights are
saved there, and ``torch.autocast`` is kept as a node that names its
device type. ``export_inference`` records that device type, the compute
dtype, the image size, the batch (None when symbolic) and the TF32
settings of the export (the numerics the certifying eval used) in the
archive (``META_NAME``), and ``read_meta`` reads them without loading the
weights. A bundle (``export_inference_bundle``, ``--export_batches``) is a
zip of ``b<batch>.pt2`` programs of concrete batches and ``META.json``.
The multi-device exports of JAX (``export_inference_sharded`` :125,
``export_inference_spatial`` :225, ``artifact_shard_dim`` :269) are not
ported yet (ROADMAP.md).

Workflow::

    export_inference(model, 512, 1024, path="bisenet.pt2")  # train host
    serve = load_exported("bisenet.pt2")                     # serving host
    labels = serve(images_u8)                                # any batch size
"""

from __future__ import annotations

import contextlib
import io
import json
import zipfile
from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn

# registers the custom ops an artifact may hold (the serving host loads
# them through these imports)
from ..ops.cuda import OP_NAMESPACE, int8_conv, upsample_argmax  # noqa: F401

#: the archive entry (``extra_files`` of ``torch.export.save``) that holds
#: an artifact's metadata
META_NAME = "dseg_meta.json"
#: a bundle's index: {"batches": [...], "device": ..., ...}
BUNDLE_META = "META.json"
#: the custom ops an artifact may hold, as the metadata names them
OPS = ("int8_conv", "upsample_argmax")


class Exported(NamedTuple):
    """An artifact: the ``torch.export`` program and its metadata."""
    program: torch.export.ExportedProgram
    meta: Dict


class ServingModule(nn.Module):
    """``images -> int32 (B, H, W) trainIds`` over a frozen model (JAX
    ``make_serving_fn`` :40).

    preprocess: the input is uint8 NHWC (the decoded, resized frames), and
    ``/255`` then the ImageNet normalisation run here in fp32, in the
    order of ``data/pipeline.py::prepare_batch``'s eval path, then the
    NCHW permute and the cast to the compute dtype; otherwise the input
    is normalised NCHW in the compute dtype (what ``evaluate`` takes).
    The forward is ``train/evaluate.py::predict``: under ``amp_dtype``'s
    autocast, ``features`` then the ``dseg::upsample_argmax`` kernel
    (``use_fused_kernel``), or the full forward then ``argmax``."""

    def __init__(self, model: nn.Module, preprocess: bool = True,
                 use_fused_kernel: bool = True,
                 amp_dtype: Optional[torch.dtype] = None):
        super().__init__()
        # the eval loop's modules are imported here, where a model is
        # exported: the serving host only loads (read_exported)
        from ..data.pipeline import IMAGENET_MEAN, IMAGENET_STD
        from ..train.evaluate import predict

        self._predict = predict
        self.model = model
        self.preprocess = preprocess
        self.use_fused_kernel = use_fused_kernel
        self.amp_dtype = amp_dtype
        device = next(model.parameters()).device
        self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN).to(
            device), persistent=False)
        self.register_buffer("std", torch.from_numpy(IMAGENET_STD).to(
            device), persistent=False)

    def normalise(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC -> normalised NCHW in the compute dtype."""
        x = (images.float() / 255.0 - self.mean) / self.std
        return x.permute(0, 3, 1, 2).contiguous().to(
            self.amp_dtype or torch.float32)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.normalise(images) if self.preprocess else images
        return self._predict(self.model, x, self.use_fused_kernel,
                             self.amp_dtype)


def make_serving_fn(model: nn.Module, preprocess: bool = True,
                    use_fused_kernel: bool = True,
                    amp_dtype: Optional[torch.dtype] = None) -> ServingModule:
    """The serving forward of ``model`` (put in eval mode) as a module."""
    return ServingModule(model.eval(), preprocess, use_fused_kernel,
                         amp_dtype).eval()


def _held_ops(program: torch.export.ExportedProgram):
    """The names of ``OPS`` the program's graph calls (autocast's regions
    are submodules of it)."""
    targets = set()
    for module in program.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            targets |= {node.target for node in module.graph.nodes
                        if node.op == "call_function"}
    ops = getattr(torch.ops, OP_NAMESPACE)
    return [name for name in OPS if getattr(ops, name).default in targets]


def _save(program, meta, f) -> None:
    torch.export.save(program, f, extra_files={META_NAME: json.dumps(meta)})


def export_inference(model: nn.Module, height: int, width: int,
                     batch: Optional[int] = None, preprocess: bool = True,
                     use_fused_kernel: bool = True,
                     amp_dtype: Optional[torch.dtype] = None,
                     device: Optional[torch.device] = None,
                     path: Optional[str] = None) -> Exported:
    """Export the serving forward of ``model`` (on ``device``, default its
    parameters') for (B, ``height``, ``width``) frames, and save it to
    ``path`` when given (JAX :76). ``batch`` None: a symbolic batch, any
    size from 1; else that batch only. ``use_fused_kernel``: the program
    must hold ``dseg::upsample_argmax``, or this raises; it is never
    exported without the kernel (the kernel serves every shape below its
    32-bit index limit)."""
    device = torch.device(device) if device is not None else next(
        model.parameters()).device
    serving = make_serving_fn(model.to(device), preprocess,
                              use_fused_kernel, amp_dtype)
    example_batch = 2 if batch is None else batch
    dtype = amp_dtype or torch.float32
    if preprocess:
        example = torch.zeros((example_batch, height, width, 3),
                              dtype=torch.uint8, device=device)
    else:
        example = torch.zeros((example_batch, 3, height, width), dtype=dtype,
                              device=device)
    dynamic = ({"images": {0: torch.export.Dim("b", min=1)}}
               if batch is None else None)
    with torch.no_grad():
        program = torch.export.export(serving, (example,),
                                      dynamic_shapes=dynamic)
    ops = _held_ops(program)
    if use_fused_kernel and "upsample_argmax" not in ops:
        raise RuntimeError("the exported program does not hold "
                           "dseg::upsample_argmax")
    meta = {"device": device.type, "dtype": str(dtype).split(".")[-1],
            "height": height, "width": width, "batch": batch,
            "preprocess": preprocess, "use_fused_kernel": use_fused_kernel,
            "ops": ops,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    if path is not None:
        _save(program, meta, path)
    return Exported(program, meta)


def read_meta(path: str) -> Dict:
    """The metadata of an artifact or of a bundle, without loading any
    weights (so a host without the artifact's device can name it)."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        if BUNDLE_META in names:
            return json.loads(zf.read(BUNDLE_META))
        for name in names:
            if name.endswith(f"extra/{META_NAME}"):
                return json.loads(zf.read(name))
    raise ValueError(f"{path} holds no {META_NAME}: not an artifact of "
                     f"utils/export.py")


def _load(f) -> Exported:
    extra = {META_NAME: ""}
    program = torch.export.load(f, extra_files=extra)
    return Exported(program, json.loads(extra[META_NAME]))


def read_exported(path: str) -> Exported:
    """Load an ``export_inference`` artifact (JAX :290)."""
    return _load(path)


def load_exported(path: str):
    """An ``export_inference`` artifact as a callable module (JAX :297):
    ``images_u8 -> int32 labels`` on the artifact's device."""
    return read_exported(path).program.module()


def export_inference_bundle(model: nn.Module, height: int, width: int,
                            batches: Sequence[int], preprocess: bool = True,
                            use_fused_kernel: bool = True,
                            amp_dtype: Optional[torch.dtype] = None,
                            device: Optional[torch.device] = None,
                            path: Optional[str] = None
                            ) -> Dict[int, Exported]:
    """One program per concrete batch size in one zip (JAX :305):
    ``b<batch>.pt2`` entries and ``BUNDLE_META`` ({"batches": [...]} and
    the programs' shared metadata). ``serve.py`` runs the largest batch
    that fits ``--batch_size`` and the ragged tail on the smallest that
    fits it. Returns {batch: Exported}."""
    batches = sorted(set(int(b) for b in batches))
    if not batches or batches[0] < 1:
        raise ValueError(f"need batch sizes >= 1, got {batches}")
    out = {b: export_inference(model, height, width, batch=b,
                               preprocess=preprocess,
                               use_fused_kernel=use_fused_kernel,
                               amp_dtype=amp_dtype, device=device)
           for b in batches}
    if path is not None:
        meta = {**out[batches[0]].meta, "batch": None, "batches": batches}
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr(BUNDLE_META, json.dumps(meta))
            for b, exported in out.items():
                buf = io.BytesIO()
                _save(exported.program, exported.meta, buf)
                zf.writestr(f"b{b}.pt2", buf.getvalue())
    return out


def read_exported_bundle(path: str) -> Dict[int, Exported]:
    """Load an ``export_inference_bundle`` zip: {batch: Exported} (JAX
    :353)."""
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read(BUNDLE_META))
        return {int(b): _load(io.BytesIO(zf.read(f"b{b}.pt2")))
                for b in meta["batches"]}


def is_bundle(path: str) -> bool:
    """True for an ``export_inference_bundle`` zip. A ``.pt2`` is a zip
    too, so this looks for the bundle's index (JAX :364 asks only
    ``zipfile.is_zipfile``)."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as zf:
        return BUNDLE_META in zf.namelist()


@contextlib.contextmanager
def export_numerics(meta: Dict):
    """The TF32 settings the artifact was exported under (``--dtype
    float32`` evaluates with TF32 off), restored on exit: a replay then
    computes what the certifying eval computed."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = meta["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = meta["matmul_allow_tf32"]
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
