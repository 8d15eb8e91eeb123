"""The height-sharded mesh (``--spatial_devices``): each rank holds a band
of image rows.

Counterpart of ``dasemanticsegmentationaml_tpu/parallel/mesh.py``
(:86-135: ``check_spatial_height``, ``create_mesh_spatial``,
``spatial_batch_sharding``) and of what XLA's partitioner does there
without being asked. JAX shards the NHWC height over the mesh axis
``spatial`` and GSPMD inserts a halo exchange before every convolution
and a reduction for every global mean. Here each rank is one
``torch.distributed`` rank; world rank r is data index ``r // S`` and
spatial index ``r % S``, and every exchange is explicit:

* ``Rows`` partitions a tensor's global rows into one contiguous band a
  spatial rank. The input is split evenly, which ``check_spatial_height``
  keeps whole at every stride-2 stage of G. A layer's output rows go to
  the owner of each row's centre tap (``layer_rows``): for G's layers
  that is the even split again; the depthwise discriminators' pointwise
  convs keep the reference's ``padding=1`` (each adds a row above and
  below the map), so D's bands come out unequal, and their partitions
  are carried through D's layers (``discriminator``).
* ``SpatialMesh.exchange`` fetches the global rows ``[lo, hi)`` a rank
  needs from the ranks that own them, zeros outside the image, as an
  autograd function: its backward sends the gradient of each borrowed
  row back to its owner, which adds it. Point-to-point over the spatial
  group: NCCL between cards; under gloo (the CPU, or ranks sharing one
  card) the rows go through host memory.
* Banded forms of every spatial op of BiSeNet-STDC813 and the three
  discriminators: ``conv_band`` (each k, s, p: the band's rows plus the
  halo the taps reach, padded only at the global top and bottom: the
  convolution runs with no row padding on rows whose outside ones are
  zeros), ``pool_band`` (``AvgPool2d(3, 2, 1)``, count_include_pad, so 9
  divides every window as in the full op), ``band_mean`` (ARM, the
  context path and FFM: a spatial-group sum over the global H·W, with
  the matching backward), ``resize_band`` (the align_corners resize from
  the global taps) and the row windows of the fused kernels
  (``band_ce``, ``predict_band``). ``upsample_nearest`` stays local:
  shard-aligned ×2 ratios map whole rows.
* ``convert`` swaps G's modules in place and keeps their ``Parameter``s,
  so state-dict (and ``.pth``) names do not change: every ``nn.Conv2d``
  whose rows need a halo becomes a ``BandedConv2d``, the pool a
  ``BandedAvgPool2d``, the global means and the nearest upsample the
  mesh's, and BN the sync BN of the world group (data × spatial). The BN
  layers that normalise the global-context vectors (ARM's ``bn_atten``,
  the context path's ``conv_avg``), whose (B, C, 1, 1) inputs every
  spatial rank holds whole, sync over the data group only, so that their
  count is the global batch's. Outside ``banded()`` every converted
  module computes as before. A ``QuantBlock`` of an int8 model
  (``ops/quantize.py``) keeps its ``conv`` child and takes the mesh: in
  ``banded()`` it fetches its halo (``conv_window``) and runs the int8
  kernel on the window with no row padding, which is the whole block's
  rows bit for bit (integer sums, an elementwise epilogue).
* Serving (``utils/export.py::export_inference_spatial``): a band's
  forward is traced, one program a spatial rank, with a mesh that has no
  group (``SpatialMesh.for_export``). While ``torch.export`` traces, an
  exchange is the custom op ``dseg::halo_exchange`` and a global mean's
  group sum ``dseg::spatial_sum`` (JAX's artifact holds GSPMD's
  collective-permutes, JAX ``utils/export.py:225-265``): each node
  records its geometry (the partition, the rows each band reads, the
  spatial index it was traced for), and at run time reads the group from
  the mesh the serving rank registers (``serve_on``). Only the forward:
  training keeps the autograd functions.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda import OP_NAMESPACE
from ..ops.quantize import QuantBlock
from ..ops.resize import RowWindow, _align_corners_taps, upsample_nearest
from .distributed import barrier, collective_device
from .sync_bn import SyncBatchNorm2d, convert_sync_batchnorm


def check_spatial_height(height: int, spatial_size: int,
                         n_downsamples: int = 5) -> None:
    """Refuse image heights whose downsampled stages go off the spatial
    grid (JAX mesh.py:86-113, copied with its message): every stage of
    the k3-s2-p1 chain (H -> ceil(H/2), ``n_downsamples`` times for STDC's
    stride-32 pyramid) must keep whole shard-aligned rows."""
    rows = height
    for i in range(n_downsamples + 1):
        if rows % spatial_size:
            raise ValueError(
                f"image height {height} is not spatially shardable over "
                f"{spatial_size} devices: the stride-{2 ** i} stage has "
                f"{rows} rows (not divisible by {spatial_size}); "
                "sub-shard stages give wrong gradients under XLA SPMD "
                "(involuntary-remat resharding)")
        rows = -(-rows // 2)


class Rows(NamedTuple):
    """A partition of ``bounds[-1]`` global rows: spatial rank s holds
    ``[bounds[s], bounds[s + 1])``."""
    bounds: Tuple[int, ...]

    @property
    def n(self) -> int:
        return self.bounds[-1]

    def band(self, s: int) -> Tuple[int, int]:
        return self.bounds[s], self.bounds[s + 1]

    @staticmethod
    def even(n: int, parts: int) -> "Rows":
        if n % parts:
            raise ValueError(f"{n} rows do not split into {parts} bands")
        return Rows(tuple(s * n // parts for s in range(parts + 1)))


def layer_rows(rows: Rows, n_out: int, kernel: int, stride: int,
               padding: int) -> Rows:
    """The partition of a layer's ``n_out`` output rows: row o goes to
    the owner of its centre tap ``o * stride - padding + (kernel - 1) //
    2`` (clamped into the image), so each band computes from its own rows
    and a halo. Even in, even out for G's layers."""
    centre = (kernel - 1) // 2
    bounds = [0]
    for b in rows.bounds[1:-1]:
        o = -(-(b + padding - centre) // stride)
        bounds.append(min(max(o, bounds[-1]), n_out))
    bounds.append(n_out)
    return Rows(tuple(bounds))


def window_needs(out_rows: Rows, kernel: int, stride: int,
                 padding: int) -> Tuple[Tuple[int, int], ...]:
    """The input rows ``[lo, hi)`` each band of ``out_rows`` reads."""
    needs = []
    for s in range(len(out_rows.bounds) - 1):
        o0, o1 = out_rows.band(s)
        lo = o0 * stride - padding
        needs.append((lo, max(lo, (o1 - 1) * stride - padding + kernel)))
    return tuple(needs)


def align_corners_needs(h: int, out_rows: Rows
                        ) -> Tuple[Tuple[int, int], ...]:
    """The logits rows ``[lo, hi)`` each band of ``out_rows`` reads in an
    align_corners upsample of ``h`` rows to ``out_rows.n``: from the lo
    tap of its first row to the hi tap of its last, computed from the
    taps (a band's may lie a row outside it)."""
    lo, hi, _ = _align_corners_taps(h, out_rows.n)
    return tuple((int(lo[a]), int(hi[b - 1]) + 1) for a, b in
                 (out_rows.band(s) for s in range(len(out_rows.bounds) - 1)))


class HaloPlan(NamedTuple):
    """One rank's part in an exchange: ``own`` (band rows a:b to window
    row c), ``recv`` (peer, window rows a:b) and ``send`` (peer, band rows
    a:b), peers as global ranks, and the window's row count."""
    own: Optional[Tuple[int, int, int]]
    recv: Tuple[Tuple[int, int, int], ...]
    send: Tuple[Tuple[int, int, int], ...]
    length: int


@functools.lru_cache(maxsize=4096)
def halo_plan(rows: Rows, needs: Tuple[Tuple[int, int], ...], s: int,
              peers: Tuple[int, ...]) -> HaloPlan:
    """The plan of spatial rank ``s`` (global ranks ``peers`` by spatial
    index) when band t holds ``rows.band(t)`` and reads ``needs[t]``."""
    lo, hi = needs[s]
    b0, b1 = rows.band(s)
    own, recv, send = None, [], []
    for t in range(len(peers)):
        t0, t1 = rows.band(t)
        a, b = max(lo, t0), min(hi, t1)
        if a < b:
            if t == s:
                own = (a - b0, b - b0, a - lo)
            else:
                recv.append((peers[t], a - lo, b - lo))
        if t != s:
            a, b = max(needs[t][0], b0), min(needs[t][1], b1)
            if a < b:
                send.append((peers[t], a - b0, b - b0))
    return HaloPlan(own, tuple(recv), tuple(send), hi - lo)


class _Halo(torch.autograd.Function):
    """The window of global rows a rank reads (``SpatialMesh.exchange``)."""

    @staticmethod
    def forward(ctx, x, plan: HaloPlan, mesh: "SpatialMesh"):
        ctx.plan, ctx.mesh, ctx.rows = plan, mesh, x.shape[2]
        return _halo_window(x, plan, mesh)

    @staticmethod
    def backward(ctx, g):
        plan, mesh = ctx.plan, ctx.mesh
        b, c, _, w = g.shape
        dx = g.new_zeros((b, c, ctx.rows, w))
        if plan.own is not None:
            a, e, at = plan.own
            dx[:, :, a:e] += g[:, :, at:at + e - a]
        got = mesh.p2p([(p, g[:, :, a:e]) for p, a, e in plan.recv],
                       [(p, (b, c, e - a, w)) for p, a, e in plan.send], g)
        for (_, a, e), t in zip(plan.send, got):
            dx[:, :, a:e] += t
        return dx, None, None


def _halo_window(x: torch.Tensor, plan: HaloPlan,
                 mesh: "SpatialMesh") -> torch.Tensor:
    """The window ``plan`` describes: this rank's own rows, the peers'
    received, zeros outside the image."""
    b, c, _, w = x.shape
    out = x.new_zeros((b, c, plan.length, w))
    if plan.own is not None:
        a, e, at = plan.own
        out[:, :, at:at + e - a] = x[:, :, a:e]
    got = mesh.p2p([(p, x[:, :, a:e]) for p, a, e in plan.send],
                   [(p, (b, c, e - a, w)) for p, a, e in plan.recv], x)
    for (_, a, e), t in zip(plan.recv, got):
        out[:, :, a:e] = t
    return out


#: the mesh of a serving rank, read by the ops of a loaded spatial
#: artifact (``serve_on``)
_SERVING: Dict[str, "SpatialMesh"] = {}


def serve_on(mesh: Optional["SpatialMesh"]) -> None:
    """Register ``mesh`` (this rank's, of the serving group) for the
    exchanges and sums of a loaded spatial artifact; None clears it."""
    if mesh is None:
        _SERVING.pop("mesh", None)
    else:
        _SERVING["mesh"] = mesh


def _serving_mesh(index: int) -> "SpatialMesh":
    mesh = _SERVING.get("mesh")
    if mesh is None:
        raise RuntimeError(
            "a spatial artifact's collective runs on a serving rank: "
            "register the rank's mesh with parallel.spatial.serve_on first")
    if mesh.spatial_index != index:
        raise RuntimeError(f"this program was traced for spatial rank "
                           f"{index}; this rank is {mesh.spatial_index}")
    return mesh


def _pairs(flat: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(a), int(b)) for a, b in zip(flat[::2], flat[1::2]))


@torch.library.custom_op(f"{OP_NAMESPACE}::halo_exchange", mutates_args=())
def _halo_op(x: torch.Tensor, bounds: List[int], needs: List[int],
             index: int) -> torch.Tensor:
    """``dseg::halo_exchange``: the window of global rows ``needs[index]``
    (flattened pairs) of the tensor partitioned by ``bounds`` whose band
    is ``x``, exchanged over the registered serving mesh."""
    mesh = _serving_mesh(index)
    plan = halo_plan(Rows(tuple(int(b) for b in bounds)), _pairs(needs),
                     index, mesh.peers)
    return _halo_window(x, plan, mesh)


@_halo_op.register_fake
def _halo_shape(x, bounds, needs, index):
    lo, hi = needs[2 * index], needs[2 * index + 1]
    return x.new_empty((x.shape[0], x.shape[1], hi - lo, x.shape[3]))


@torch.library.custom_op(f"{OP_NAMESPACE}::spatial_sum", mutates_args=())
def _spatial_sum_op(t: torch.Tensor, index: int) -> torch.Tensor:
    """``dseg::spatial_sum``: ``t`` summed over the registered serving
    mesh's spatial group."""
    return _serving_mesh(index).spatial_sum(t)


@_spatial_sum_op.register_fake
def _spatial_sum_shape(t, index):
    return torch.empty_like(t)


class _BandMean(torch.autograd.Function):
    """The mean over the global H·W of a tensor held in bands: the
    band's sum, summed over the spatial group, over ``count``; the
    backward sums the gradient over the group (every band's share of the
    replicated mean) and spreads it over the band."""

    @staticmethod
    def forward(ctx, x, mesh: "SpatialMesh", count: int):
        acc = torch.promote_types(x.dtype, torch.float32)
        total = mesh.spatial_sum(x.sum((2, 3), keepdim=True, dtype=acc))
        ctx.mesh, ctx.count, ctx.shape = mesh, count, x.shape
        return (total / count).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        acc = torch.promote_types(g.dtype, torch.float32)
        total = ctx.mesh.spatial_sum(g.to(acc).contiguous()) / ctx.count
        return total.to(g.dtype).expand(ctx.shape), None, None


def _row_taps(in_size: int, out_size: int, a: int, b: int, base: int,
              dtype, device):
    """(lo, hi, t) of output rows [a, b) of an align_corners resize, the
    indices rebased to ``base`` and the weights from the float64
    positions, in ``dtype`` (torch computes them in the input's
    accumulation type)."""
    lo, hi, _ = _align_corners_taps(in_size, out_size)
    if out_size == 1 or in_size == 1:
        t = np.zeros((out_size,), np.float64)
    else:
        pos = np.arange(out_size, dtype=np.float64) * (in_size - 1) \
            / (out_size - 1)
        t = pos - lo
    return (torch.from_numpy((lo[a:b] - base).astype(np.int64)).to(device),
            torch.from_numpy((hi[a:b] - base).astype(np.int64)).to(device),
            torch.from_numpy(t[a:b]).to(device, dtype))


def _two_tap_rows(x, lo, hi, t):
    t = t.view(-1, 1)
    return (1 - t) * x.index_select(2, lo) + t * x.index_select(2, hi)


class SpatialMesh:
    """The ('data', 'spatial') mesh over the default process group
    (``create_mesh_spatial``): this rank's indices, the spatial group
    (halos, global means) and the data group (the global-context BN),
    one of each a data / spatial index, made by every rank in the same
    order; the world group is the default one (BN statistics,
    gradients). ``active`` inside ``banded()``."""

    def __init__(self, data_size: int, spatial_size: int):
        world = dist.get_world_size()
        if world != data_size * spatial_size:
            raise ValueError(f"a {data_size} x {spatial_size} mesh needs "
                             f"{data_size * spatial_size} ranks, not {world}")
        self.rank = dist.get_rank()
        self.data_size, self.spatial_size = data_size, spatial_size
        self.data_index = self.rank // spatial_size
        self.spatial_index = self.rank % spatial_size
        self.spatial_group = self.data_group = None
        for d in range(data_size):
            ranks = [d * spatial_size + s for s in range(spatial_size)]
            group = dist.new_group(ranks)
            if d == self.data_index:
                self.spatial_group, self.peers = group, tuple(ranks)
        for s in range(spatial_size):
            group = dist.new_group([d * spatial_size + s
                                    for d in range(data_size)])
            if s == self.spatial_index:
                self.data_group = group
        self.device = collective_device(self.spatial_group)
        #: whether the collectives of a step can be captured in a CUDA
        #: graph (NCCL's can; gloo's go through the host)
        self.capturable = dist.get_backend(self.spatial_group) == "nccl"
        self.active = False
        #: point-to-point exchanges made in this process (each a forward
        #: or a backward of ``exchange``) and the host seconds spent in
        #: them (the whole exchange under gloo, which waits for its
        #: copies; NCCL's only enqueues)
        self.exchanges = 0
        self.exchange_seconds = 0.0
        barrier()

    @classmethod
    def for_export(cls, spatial_size: int,
                   spatial_index: int = 0) -> "SpatialMesh":
        """A mesh with no process group, for tracing one spatial rank's
        band of a serving forward (``utils/export.py``): inside
        ``banded()`` while ``torch.export`` traces, its exchanges and sums
        are the custom ops, which find the group at run time
        (``serve_on``). Set ``spatial_index`` to trace another rank's."""
        mesh = cls.__new__(cls)
        mesh.rank, mesh.data_size, mesh.spatial_size = spatial_index, 1, \
            spatial_size
        mesh.data_index, mesh.spatial_index = 0, spatial_index
        mesh.spatial_group = mesh.data_group = mesh.device = None
        mesh.peers = tuple(range(spatial_size))
        mesh.capturable = mesh.active = False
        mesh.exchanges, mesh.exchange_seconds = 0, 0.0
        return mesh

    def __deepcopy__(self, memo):
        return self   # a copy of a converted model shares the mesh

    @contextlib.contextmanager
    def banded(self):
        """Inside, converted modules compute on bands."""
        was, self.active = self.active, True
        try:
            yield self
        finally:
            self.active = was

    # ------------------------------------------------------ collectives

    def p2p(self, sends, recvs, like: torch.Tensor) -> List[torch.Tensor]:
        """Send each (peer, tensor) of ``sends`` and receive each (peer,
        shape) of ``recvs``, in one batch; the received tensors on
        ``like``'s device."""
        start = time.perf_counter()
        ops, bufs = [], []
        for peer, t in sends:
            ops.append(dist.P2POp(dist.isend, t.to(self.device).contiguous(),
                                  peer, self.spatial_group))
        for peer, shape in recvs:
            buf = torch.empty(shape, dtype=like.dtype, device=self.device)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.spatial_group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = [b.to(like.device) for b in bufs]
        self.exchanges += 1
        self.exchange_seconds += time.perf_counter() - start
        return out

    def spatial_sum(self, t: torch.Tensor) -> torch.Tensor:
        out = t.to(self.device, copy=True)
        dist.all_reduce(out, group=self.spatial_group)
        return out.to(t.device)

    def exchange(self, x: torch.Tensor, rows: Rows,
                 needs: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
        """This rank's window of global rows ``needs[s]`` of the tensor
        whose band ``rows.band(s)`` is ``x``; zeros outside the image.
        Every rank of the spatial group calls it with the same ``rows``
        and ``needs``. While ``torch.export`` traces: the op
        ``dseg::halo_exchange`` (forward only)."""
        if torch.compiler.is_exporting():
            return _halo_op(x, list(rows.bounds),
                            [int(v) for pair in needs for v in pair],
                            self.spatial_index)
        plan = halo_plan(rows, needs, self.spatial_index, self.peers)
        return _Halo.apply(x, plan, self)

    def even_rows(self, x: torch.Tensor) -> Rows:
        """The even partition of the tensor whose band is ``x``."""
        return Rows.even(x.shape[2] * self.spatial_size, self.spatial_size)

    def valid_count(self, labels: torch.Tensor, num_classes: int,
                    ignore_index: int = 255) -> torch.Tensor:
        """The valid pixels of the global batch (every rank's band),
        clamped to 1, as an fp32 device scalar: a CE share's divisor."""
        valid = (labels != ignore_index) & (labels >= 0) \
            & (labels < num_classes)
        total = valid.sum(dtype=torch.int64).reshape(1).to(self.device)
        dist.all_reduce(total)
        return total.to(labels.device).clamp_min(1).float().reshape(())

    # ----------------------------------------------------- banded ops

    def conv_window(self, conv: nn.Conv2d, x: torch.Tensor, rows: Rows
                    ) -> Tuple[torch.Tensor, Rows]:
        """(the rows ``conv`` reads for this rank's band of its output,
        zeros outside the image, the output's partition), for the band
        ``x`` of a tensor partitioned by ``rows``. The window is
        convolved with no row padding."""
        k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
        if conv.dilation != (1, 1) or conv.padding_mode != "zeros":
            raise ValueError(f"{conv}: only undilated zero-padded convs")
        n_out = (rows.n + 2 * p - k) // s + 1
        out_rows = layer_rows(rows, n_out, k, s, p)
        o0, o1 = out_rows.band(self.spatial_index)
        if o1 <= o0:
            raise ValueError(f"{conv}: an empty band of {n_out} output "
                             f"rows over {self.spatial_size} ranks")
        return self.exchange(x, rows, window_needs(out_rows, k, s, p)), \
            out_rows

    def conv_band(self, conv: nn.Conv2d, x: torch.Tensor, rows: Rows
                  ) -> Tuple[torch.Tensor, Rows]:
        """``conv`` on the band ``x`` of a tensor partitioned by
        ``rows``: (the output band, the output's partition)."""
        win, out_rows = self.conv_window(conv, x, rows)
        return F.conv2d(win, conv.weight, conv.bias, conv.stride,
                        (0, conv.padding[1]), 1, conv.groups), out_rows

    def pool_band(self, pool: nn.AvgPool2d, x: torch.Tensor) -> torch.Tensor:
        """``AvgPool2d`` with count_include_pad on an even band."""
        k, s, p = (v if isinstance(v, int) else v[0] for v in
                   (pool.kernel_size, pool.stride, pool.padding))
        if not pool.count_include_pad or pool.ceil_mode \
                or pool.divisor_override is not None:
            raise ValueError(f"{pool}: only count_include_pad pooling")
        rows = self.even_rows(x)
        n_out = (rows.n + 2 * p - k) // s + 1
        out_rows = layer_rows(rows, n_out, k, s, p)
        win = self.exchange(x, rows, window_needs(out_rows, k, s, p))
        return F.avg_pool2d(win, k, s, (0, p), count_include_pad=True)

    def mean_hw(self, x: torch.Tensor) -> torch.Tensor:
        """``x.mean((2, 3), keepdim=True)`` over the global H·W."""
        if not self.active:
            return x.mean(dim=(2, 3), keepdim=True)
        count = x.shape[2] * x.shape[3] * self.spatial_size
        if torch.compiler.is_exporting():
            # the forward alone, its group sum the op dseg::spatial_sum
            acc = torch.promote_types(x.dtype, torch.float32)
            total = _spatial_sum_op(x.sum((2, 3), keepdim=True, dtype=acc),
                                    self.spatial_index)
            return (total / count).to(x.dtype)
        return _BandMean.apply(x, self, count)

    def upsample_nearest(self, x: torch.Tensor, out_hw) -> torch.Tensor:
        """The context path's nearest upsample: local on shard-aligned
        bands, where a ×2 ratio maps whole rows (or a 1×1 map is
        broadcast)."""
        if self.active and x.shape[2] != 1 and out_hw[0] != 2 * x.shape[2]:
            raise ValueError(f"a banded nearest upsample takes a x2 ratio, "
                             f"not {x.shape[2]} -> {out_hw[0]} rows")
        return upsample_nearest(x, out_hw)

    def resize_band(self, x: torch.Tensor, out_hw) -> torch.Tensor:
        """The align_corners bilinear resize of the even band ``x`` to
        the band of ``out_hw`` rows (the global taps of those rows, a halo
        from the neighbours), in ``x``'s dtype (fp32 or wider inside).
        Outside ``banded()``: ``F.interpolate``."""
        if not self.active:
            return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                                 align_corners=True)
        s, parts = self.spatial_index, self.spatial_size
        rows = self.even_rows(x)
        out_rows = Rows.even(out_hw[0] * parts, parts)
        needs = align_corners_needs(rows.n, out_rows)
        win = self.exchange(x, rows, needs)
        acc = torch.promote_types(x.dtype, torch.float32)
        a, b = out_rows.band(s)
        lo, hi, t = _row_taps(rows.n, out_rows.n, a, b, needs[s][0], acc,
                              x.device)
        up = _two_tap_rows(win.to(acc), lo, hi, t)
        w, out_w = x.shape[3], int(out_hw[1])
        lo, hi, t = _row_taps(w, out_w, 0, out_w, 0, acc, x.device)
        up = _two_tap_rows(up.transpose(2, 3), lo, hi, t).transpose(2, 3)
        return up.to(x.dtype)

    def window(self, x: torch.Tensor, out_rows_band: int):
        """(the logits window, its ``RowWindow``) of this rank's band of
        output rows of an align_corners upsample of the even band ``x``
        to ``out_rows_band`` rows a band."""
        s, parts = self.spatial_index, self.spatial_size
        rows = self.even_rows(x)
        out_rows = Rows.even(out_rows_band * parts, parts)
        needs = align_corners_needs(rows.n, out_rows)
        win = self.exchange(x, rows, needs)
        a, b = out_rows.band(s)
        return win.contiguous(), RowWindow(a, b, rows.n, out_rows.n,
                                           needs[s][0])

    def band_ce(self, ce, logits: torch.Tensor, labels: torch.Tensor,
                ignore_index: int, n_valid: torch.Tensor) -> torch.Tensor:
        """This band's share of the global mean CE(ignore) of one head:
        ``ce`` (the fused upsample+CE) on the band's row window over the
        global count ``n_valid``."""
        win, window = self.window(logits, labels.shape[1])
        return ce(win, labels, tuple(labels.shape[1:]), ignore_index,
                  window=window, n_valid=n_valid)

    def predict_band(self, feat: torch.Tensor, out_hw) -> torch.Tensor:
        """The eval kernel on this rank's band of output rows."""
        from ..ops.cuda.upsample_argmax import upsample_argmax

        win, window = self.window(feat, int(out_hw[0]))
        return upsample_argmax(win, tuple(out_hw), window=window)

    def discriminator(self, d: nn.Module, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, Rows]:
        """D's forward on the even band ``x`` (``d.layers()``): each conv
        banded, its partition carried to the next (the DW D's pointwise
        ``padding=1`` convs make the bands unequal); (this rank's band of
        D's output, the output's partition)."""
        rows = self.even_rows(x)
        for conv, norm, act in d.layers():
            x, rows = self.conv_band(conv, x, rows)
            if norm is not None:
                x = norm(x)
            if act:
                x = F.leaky_relu(x, negative_slope=0.2)
        return x, rows

    def count_of(self, out: torch.Tensor, rows: Rows) -> int:
        """The element count of the global output whose band is ``out``
        (every data shard's batch is the same size)."""
        return self.data_size * out.shape[0] * out.shape[1] * rows.n \
            * out.shape[3]

    def shards(self, images: torch.Tensor) -> bool:
        """Whether a batch of the global size splits over the data axis."""
        return images.shape[0] % self.data_size == 0

    def shard(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """This rank's rows of the global batch and band of its height
        (dim 1 of (B, H, W), dim 2 of (B, C, H, W))."""
        out = []
        for t in tensors:
            b = t.shape[0] // self.data_size
            t = t[self.data_index * b:(self.data_index + 1) * b]
            out.append(keep_band(t, self.spatial_index,
                                 self.spatial_size).contiguous())
        return tuple(out)

    # ------------------------------------------------------- convert

    def convert(self, model: nn.Module) -> nn.Module:
        """Convert a BiSeNet or a discriminator in place (module
        docstring); returns it. Parameters and buffers are kept."""
        convert_sync_batchnorm(model)
        for m in model.modules():
            replicated = []
            if hasattr(m, "bn_atten"):
                replicated.append(m.bn_atten)
            if hasattr(m, "conv_avg"):
                replicated.append(m.conv_avg.bn)
            for bn in replicated:
                if isinstance(bn, SyncBatchNorm2d):
                    bn.group = self.data_group
            if hasattr(type(m), "mean_hw"):
                m.mean_hw = self.mean_hw
            if hasattr(type(m), "upsample"):
                m.upsample = self.upsample_nearest
            if hasattr(type(m), "resize"):
                m.resize = self.resize_band
        _swap_banded(model, self)
        return model


def keep_band(t: torch.Tensor, index: int, count: int) -> torch.Tensor:
    """Rows ``[index H / count, (index + 1) H / count)`` of a (B, H, W)
    or (B, C, H, W) batch."""
    axis = 1 if t.dim() == 3 else 2
    n = t.shape[axis] // count
    return t.narrow(axis, index * n, n)


class BandedConv2d(nn.Conv2d):
    """An ``nn.Conv2d`` that, inside ``mesh.banded()``, computes its even
    band of output rows (``SpatialMesh.conv_band``)."""

    mesh: SpatialMesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.mesh.active:
            return super().forward(x)
        return self.mesh.conv_band(self, x, self.mesh.even_rows(x))[0]


class BandedAvgPool2d(nn.AvgPool2d):
    """``nn.AvgPool2d`` with ``SpatialMesh.pool_band`` inside
    ``mesh.banded()``."""

    mesh: SpatialMesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.mesh.active:
            return super().forward(x)
        return self.mesh.pool_band(self, x)


def _needs_halo(conv: nn.Conv2d) -> bool:
    return (conv.kernel_size[0], conv.stride[0], conv.padding[0]) != (1, 1, 0)


def _int8(block: nn.Module) -> bool:
    """Whether ``block`` runs the int8 kernel (an enabled entry)."""
    return (isinstance(block, QuantBlock) and block.quant_mode == "int8"
            and block.quant is not None and "disabled" not in block.quant)


def _swap_banded(module: nn.Module, mesh: SpatialMesh) -> None:
    """Every ``nn.Conv2d`` whose rows read a halo (not 1×1 s1 p0) and
    every ``nn.AvgPool2d`` under ``module`` becomes its banded form,
    holding the same parameters; an int8 ``QuantBlock`` takes the mesh
    and keeps its ``conv`` (its int8 path reads the halo itself). Modules
    converted before are pointed at ``mesh``."""
    for name, child in list(module.named_children()):
        if _int8(child) or isinstance(child, (BandedConv2d,
                                              BandedAvgPool2d)):
            child.mesh = mesh
        elif type(child) is nn.Conv2d and _needs_halo(child):
            banded = BandedConv2d(
                child.in_channels, child.out_channels, child.kernel_size,
                child.stride, child.padding, child.dilation, child.groups,
                child.bias is not None, child.padding_mode, device="meta")
            banded.weight = child.weight
            banded.bias = child.bias
            banded.train(child.training)
            banded.mesh = mesh
            setattr(module, name, banded)
        elif type(child) is nn.AvgPool2d:
            banded = BandedAvgPool2d(child.kernel_size, child.stride,
                                     child.padding, child.ceil_mode,
                                     child.count_include_pad,
                                     child.divisor_override)
            banded.mesh = mesh
            setattr(module, name, banded)
        else:
            _swap_banded(child, mesh)


def create_mesh_spatial(data_size: int, spatial_size: int) -> SpatialMesh:
    """The ('data', 'spatial') mesh over the default group's ranks (JAX
    mesh.py:116-130): batch × image height."""
    return SpatialMesh(data_size, spatial_size)
