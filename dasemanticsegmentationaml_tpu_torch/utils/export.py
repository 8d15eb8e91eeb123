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

The multi-device exports (JAX :125-288) are programs a rank, served by N
ranks of a process group (``serve.py``); their metadata records
``nr_devices`` and ``shard_dim`` (``artifact_shard_dim``):

* ``export_inference_sharded`` (JAX :125): the batch over N ranks. Each
  rank runs the one-device program, fused kernel included, on its shard
  of the batch: the artifact is that program (a symbolic batch a rank,
  JAX's ``N*b``, or the concrete ``batch / N``), ``shard_dim`` 0. A
  bundle of such programs is ``export_inference_bundle(..., devices=N)``
  (JAX :305-345).
* ``export_inference_spatial`` (JAX :225): the image height over N ranks,
  any batch, 1 included. One program a rank, each traced on its band
  with a mesh that has no group (``parallel/spatial.py::SpatialMesh.
  for_export``): the halo exchanges, the global means' group sums and,
  with the fused kernel, the windowed upsample+argmax are the graph's
  nodes ``dseg::halo_exchange``, ``dseg::spatial_sum`` and
  ``dseg::upsample_argmax_window``, as JAX's artifact holds GSPMD's
  collective-permutes; they find the serving rank's group at run time.
  The programs are ``r<k>.pt2`` entries of one zip beside ``META.json``;
  ``shard_dim`` 1.

Workflow::

    export_inference(model, 512, 1024, path="bisenet.pt2")  # train host
    serve = load_exported("bisenet.pt2")                     # serving host
    labels = serve(images_u8)                                # any batch size
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import zipfile
from typing import Dict, NamedTuple, Optional, Sequence, Union

import torch
import torch.nn as nn

# registers the custom ops an artifact may hold (the serving host loads
# them through these imports)
from ..ops.cuda import OP_NAMESPACE, int8_conv, upsample_argmax  # noqa: F401
from ..parallel import spatial as _spatial

#: the archive entry (``extra_files`` of ``torch.export.save``) that holds
#: an artifact's metadata
META_NAME = "dseg_meta.json"
#: the index of a zip of programs: a bundle's {"batches": [...],
#: "device": ..., ...}, or a spatial artifact's {"nr_devices": N,
#: "shard_dim": 1, ...}
BUNDLE_META = "META.json"
#: the custom ops an artifact may hold, as the metadata names them
OPS = ("int8_conv", "upsample_argmax", "upsample_argmax_window",
       "halo_exchange", "spatial_sum")


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
    (``use_fused_kernel``), or the full forward then ``argmax``.
    ``spatial``: the images are a band of rows and ``model`` is converted
    to that mesh (``predict``'s ``spatial``)."""

    def __init__(self, model: nn.Module, preprocess: bool = True,
                 use_fused_kernel: bool = True,
                 amp_dtype: Optional[torch.dtype] = None, spatial=None):
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
        self.spatial = spatial
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
                             self.amp_dtype, self.spatial)


def make_serving_fn(model: nn.Module, preprocess: bool = True,
                    use_fused_kernel: bool = True,
                    amp_dtype: Optional[torch.dtype] = None,
                    spatial=None) -> ServingModule:
    """The serving forward of ``model`` (put in eval mode) as a module
    (on a band of ``spatial``'s mesh, where given)."""
    return ServingModule(model.eval(), preprocess, use_fused_kernel,
                         amp_dtype, spatial).eval()


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


def _trace(serving: ServingModule, height: int, width: int,
           batch: Optional[int], device: torch.device, meta: Dict,
           require_ops: Sequence[str] = ()) -> Exported:
    """Export ``serving`` for (B, ``height``, ``width``) inputs on
    ``device`` (``batch`` None: symbolic, any size from 1) with the
    metadata ``meta`` and the held ops; raise where an op of
    ``require_ops`` is not a node of the program."""
    example_batch = 2 if batch is None else batch
    if serving.preprocess:
        example = torch.zeros((example_batch, height, width, 3),
                              dtype=torch.uint8, device=device)
    else:
        example = torch.zeros((example_batch, 3, height, width),
                              dtype=serving.amp_dtype or torch.float32,
                              device=device)
    dynamic = ({"images": {0: torch.export.Dim("b", min=1)}}
               if batch is None else None)
    with torch.no_grad():
        program = torch.export.export(serving, (example,),
                                      dynamic_shapes=dynamic)
    ops = _held_ops(program)
    for name in require_ops:
        if name not in ops:
            raise RuntimeError(f"the exported program does not hold "
                               f"{OP_NAMESPACE}::{name}")
    return Exported(program, {**meta, "batch": batch, "ops": ops})


def _meta(device: torch.device, height: int, width: int, preprocess: bool,
          use_fused_kernel: bool, amp_dtype: Optional[torch.dtype]) -> Dict:
    dtype = amp_dtype or torch.float32
    return {"device": device.type, "dtype": str(dtype).split(".")[-1],
            "height": height, "width": width, "batch": None,
            "preprocess": preprocess, "use_fused_kernel": use_fused_kernel,
            "ops": [],
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def _device_of(model: nn.Module, device) -> torch.device:
    return torch.device(device) if device is not None else next(
        model.parameters()).device


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
    device = _device_of(model, device)
    serving = make_serving_fn(model.to(device), preprocess,
                              use_fused_kernel, amp_dtype)
    exported = _trace(serving, height, width, batch, device,
                      _meta(device, height, width, preprocess,
                            use_fused_kernel, amp_dtype),
                      ("upsample_argmax",) if use_fused_kernel else ())
    if path is not None:
        _save(*exported, path)
    return exported


def export_inference_sharded(model: nn.Module, height: int, width: int,
                             n: int, batch: Optional[int] = None,
                             preprocess: bool = True,
                             use_fused_kernel: bool = True,
                             amp_dtype: Optional[torch.dtype] = None,
                             device: Optional[torch.device] = None,
                             path: Optional[str] = None) -> Exported:
    """The batch-sharded artifact over ``n`` ranks (JAX :125): each rank
    runs the one-device program, the fused kernel a node of it as under
    JAX's ``shard_map`` route, on its rows of the batch; eval-mode BN
    needs no collective. ``batch`` None: symbolic a rank, so the artifact
    serves any multiple of ``n`` (JAX's symbolic ``n*b``); else the
    global batch, which ``n`` must divide (JAX's words). The metadata
    records ``nr_devices = n``, ``shard_dim = 0``, the global ``batch``
    and the program's ``rank_batch``."""
    if batch is not None and batch % n:
        raise ValueError(f"batch {batch} not divisible by the "
                         f"{n}-device mesh")
    rank_batch = None if batch is None else batch // n
    one = export_inference(model, height, width, batch=rank_batch,
                           preprocess=preprocess,
                           use_fused_kernel=use_fused_kernel,
                           amp_dtype=amp_dtype, device=device)
    exported = Exported(one.program, {**one.meta, "batch": batch,
                                      "rank_batch": rank_batch,
                                      "nr_devices": n, "shard_dim": 0})
    if path is not None:
        _save(*exported, path)
    return exported


def export_inference_spatial(model: nn.Module, height: int, width: int,
                             n: int, preprocess: bool = True,
                             use_fused_kernel: bool = True,
                             amp_dtype: Optional[torch.dtype] = None,
                             device: Optional[torch.device] = None,
                             path: Optional[str] = None
                             ) -> Dict[int, Exported]:
    """The height-sharded latency artifact over ``n`` ranks (JAX :225):
    any batch, 1 included; rank k serves rows ``[k H/n, (k+1) H/n)`` of
    every frame. ``height`` must pass ``check_spatial_height`` (JAX's
    "not spatially shardable" refusal, first). A copy of ``model`` is
    converted to a mesh with no group (``SpatialMesh.for_export``) and
    the band's forward traced once a rank with a symbolic batch: its
    exchanges, group sums and (``use_fused_kernel``) the windowed
    upsample+argmax are custom-op nodes (module docstring), and the
    program of a rank with neighbours must hold the exchange. Saved as
    one zip of ``r<k>.pt2`` and ``META.json`` (``shard_dim = 1``).
    Returns {rank: Exported}."""
    _spatial.check_spatial_height(height, n)
    if n < 2:
        raise ValueError("a height-sharded artifact needs 2 ranks or more "
                         "(export_inference writes the one-device one)")
    device = _device_of(model, device)
    mesh = _spatial.SpatialMesh.for_export(n)
    banded = mesh.convert(copy.deepcopy(model).to(device).eval())
    band = height // n
    meta = {**_meta(device, height, width, preprocess, use_fused_kernel,
                    amp_dtype),
            "nr_devices": n, "shard_dim": 1, "band_height": band}
    required = (("halo_exchange",) if n > 1 else ()) + (
        ("upsample_argmax_window",) if use_fused_kernel else ())
    out = {}
    for k in range(n):
        mesh.spatial_index = mesh.rank = k
        serving = make_serving_fn(banded, preprocess, use_fused_kernel,
                                  amp_dtype, spatial=mesh)
        out[k] = _trace(serving, band, width, None, device,
                        {**meta, "rank": k}, required)
    if path is not None:
        ops = sorted({op for e in out.values() for op in e.meta["ops"]})
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr(BUNDLE_META, json.dumps({**meta, "ops": ops}))
            for k, exported in out.items():
                buf = io.BytesIO()
                _save(*exported, buf)
                zf.writestr(f"r{k}.pt2", buf.getvalue())
    return out


def read_meta(path) -> Dict:
    """The metadata of an artifact, a bundle or a spatial artifact,
    without loading any weights (so a host without the artifact's device
    can name it)."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        if BUNDLE_META in names:
            return json.loads(zf.read(BUNDLE_META))
        for name in names:
            if name.endswith(f"extra/{META_NAME}"):
                return json.loads(zf.read(name))
    raise ValueError(f"{path} holds no {META_NAME}: not an artifact of "
                     f"utils/export.py")


def artifact_shard_dim(artifact: Union[str, Dict]) -> int:
    """Which input dim a multi-device artifact shards (JAX :269): 0 for
    the batch-sharded ones, 1 for the height-sharded; 0 for one device.
    ``artifact``: a path or its ``read_meta``."""
    meta = read_meta(artifact) if isinstance(artifact, str) else artifact
    if meta.get("nr_devices", 1) <= 1:
        return 0
    return int(meta["shard_dim"])


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


def read_exported_spatial(path: str, rank: int) -> Exported:
    """Load spatial rank ``rank``'s program of an
    ``export_inference_spatial`` zip."""
    with zipfile.ZipFile(path) as zf:
        return _load(io.BytesIO(zf.read(f"r{rank}.pt2")))


def export_inference_bundle(model: nn.Module, height: int, width: int,
                            batches: Sequence[int], preprocess: bool = True,
                            use_fused_kernel: bool = True,
                            amp_dtype: Optional[torch.dtype] = None,
                            device: Optional[torch.device] = None,
                            path: Optional[str] = None, devices: int = 1
                            ) -> Dict[int, Exported]:
    """One program per concrete batch size in one zip (JAX :305):
    ``b<batch>.pt2`` entries and ``BUNDLE_META`` ({"batches": [...]} and
    the programs' shared metadata). ``serve.py`` runs the largest batch
    that fits ``--batch_size`` and the ragged tail on the smallest that
    fits it. ``devices`` > 1: each a batch-sharded program
    (``export_inference_sharded``, JAX :321-324) of that global batch,
    which ``devices`` must divide. Returns {batch: Exported}."""
    batches = sorted(set(int(b) for b in batches))
    if not batches or batches[0] < 1:
        raise ValueError(f"need batch sizes >= 1, got {batches}")
    kwargs = dict(preprocess=preprocess, use_fused_kernel=use_fused_kernel,
                  amp_dtype=amp_dtype, device=device)
    if devices > 1:
        out = {b: export_inference_sharded(model, height, width, devices,
                                           batch=b, **kwargs)
               for b in batches}
    else:
        out = {b: export_inference(model, height, width, batch=b, **kwargs)
               for b in batches}
    if path is not None:
        meta = {**out[batches[0]].meta, "batch": None, "batches": batches}
        meta.pop("rank_batch", None)
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
    too, and so is a spatial artifact, so this reads the index for its
    batches (JAX :364 asks only ``zipfile.is_zipfile``)."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as zf:
        return (BUNDLE_META in zf.namelist()
                and "batches" in json.loads(zf.read(BUNDLE_META)))


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
