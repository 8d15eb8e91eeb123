"""Data-parallel train and DA steps over the ranks of a process group.

Counterpart of ``dasemanticsegmentationaml_tpu/parallel/mesh.py``
(:162-349). The reference's only parallelism is single-process
``nn.DataParallel`` (reference train.py:497, 145-152): replicas of the
module on the batch's slices, gradients mean-reduced onto device 0, BN
statistics per replica. JAX lays a device mesh over it; here each device
is a rank of a ``torch.distributed`` group (``parallel/distributed.py``)
holding its slice of the global batch, with the two BN modes of JAX:

* ``sync_bn=True``: JAX's step is one program over the global batch
  (mesh.py:195-209, :272-280), so every BN layer normalises with the
  global batch's statistics (``parallel/sync_bn.py``), and every loss is
  the global batch's: CE(ignore) is a mean over the *global* count of
  valid pixels, so each rank scales its mean by ``n_valid_local /
  n_valid_global`` (the counts summed on the stream, no host sync), OHEM
  sorts the global batch's pixel losses (``sync_ohem_cross_entropy``),
  and the discriminator's BCE, a mean over equal shards, is scaled by
  ``1 / world``; the scaled gradients are then *summed*.
* ``sync_bn=False``: the DataParallel reading (mesh.py:219-247, :303-332):
  each rank's modules keep their own BN buffers, which are JAX's tiled
  ``batch_stats``; each rank's loss is the local mean (OHEM per shard,
  mesh.py:176-179), and the gradients are mean-reduced (``pmean``).

Gradients are reduced at JAX's reduce points, each ``reduce(...)`` of
JAX train/adversarial.py:108-110: once per supervised step (per
mini-step under ``--iter_size``, as ``MultiSteps`` inside JAX's step), in
the interleaved DA step after G's phase 1 and phase 2 and after D's phase
3 and phase 4, in the combined one once for G and once for D; each point
is one ``all_reduce`` of one flat buffer of the model's gradients. The
metrics are reduced as JAX reduces them. ``DistributedDataParallel`` is
not used: its reducer assumes one forward and one backward an iteration
(D runs three forwards in a DA step, G two, and ``requires_grad`` is
toggled by ``train/adversarial.py::_frozen``), and its
``broadcast_buffers`` would overwrite the per-replica BN buffers with
rank 0's at every forward.

The export and eval convention of JAX's ``untile_state`` (shard 0's
statistics, as torch saves device 0's module) is ``rank0_buffers`` /
``untile_state``.

The height-sharded mesh (``spatial``, ``parallel/spatial.py``; JAX
``create_mesh_spatial`` with the sync step, cli.py:164-207): sync BN only,
over the world group (data × spatial). Each rank holds a band of rows of
its data shard, every loss it backpropagates is its band's share of the
global one (CE over the global valid count; OHEM over the world's pixel
losses in the global batch's order; D's BCE over D's global output
count, since D's bands are unequal), and the ``Reducer`` of the world
sums the gradients, as above.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..ops.cuda.fused_ce import cross_entropy_upsampled
from ..ops.losses import _per_pixel_ce, ohem_cross_entropy
from ..train.adversarial import make_da_step
from ..train.supervised import make_supervised_loss
from .sync_bn import convert_sync_batchnorm


def valid_count(labels: torch.Tensor, num_classes: int,
                ignore_index: int = 255) -> torch.Tensor:
    """The pixels CE(ignore) averages over, as an int64 device scalar
    (``ops/losses.py``'s valid rule)."""
    valid = (labels != ignore_index) & (labels >= 0) & (labels < num_classes)
    return valid.sum(dtype=torch.int64)


class Reducer:
    """The collectives of one data-parallel step over ``group``.

    Every loss a rank backpropagates is its *share* of the step's loss, so
    that the shares' gradients, summed over the ranks, are the gradients
    of the step's loss: ``ce_share`` for a CE(ignore) mean (sync:
    ``n_local / n_global``; per replica: ``1 / world``), ``mean_share``
    (``1 / world``) for a mean over equal shards. ``grads`` sums the
    gradients of an optimizer's parameters, ``total`` the shares'
    values, each in one flat ``all_reduce``."""

    def __init__(self, group=None, *, sync_bn: bool, num_classes: int,
                 ignore_index: int = 255):
        self.group = group
        self.sync_bn = sync_bn
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.world = dist.get_world_size(group)
        self.mean_share = 1.0 / self.world

    def ce_share(self, labels: torch.Tensor):
        """The factor that turns this rank's CE(ignore) mean over
        ``labels`` into its share of the step's loss."""
        if not self.sync_bn:
            return self.mean_share
        local = valid_count(labels, self.num_classes, self.ignore_index)
        total = local.clone()
        dist.all_reduce(total, group=self.group)
        return local.float() / total.clamp_min(1).float()

    def grads(self, optimizer: torch.optim.Optimizer) -> None:
        """Sum the gradients of ``optimizer``'s parameters over the ranks,
        in place: one flat buffer a dtype. A parameter without a gradient
        has none on every rank (the ranks run one program)."""
        grads = [p.grad for group in optimizer.param_groups
                 for p in group["params"] if p.grad is not None]
        for dtype in sorted({g.dtype for g in grads}, key=str):
            same = [g for g in grads if g.dtype == dtype]
            flat = torch.cat([g.reshape(-1) for g in same])
            dist.all_reduce(flat, group=self.group)
            torch._foreach_copy_(
                same, [f.view_as(g) for f, g in
                       zip(flat.split([g.numel() for g in same]), same)])

    def total(self, shares: List[torch.Tensor]) -> torch.Tensor:
        """The shares' values summed over the ranks, stacked in their
        widest dtype."""
        dtype = functools.reduce(torch.promote_types,
                                 (s.dtype for s in shares))
        flat = torch.stack([s.detach().to(dtype) for s in shares])
        dist.all_reduce(flat, group=self.group)
        return flat


def sync_ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                            threshold: float, keep_num: int,
                            ignore_index: int = 255,
                            group=None, layout=None) -> torch.Tensor:
    """This rank's share of OHEM CE over the group's global batch (JAX
    ops/losses.py:61-90 run by the global program of the sync step): the
    pixel losses of every rank are gathered in rank order (each rank's
    rows, as in the global batch), the global ``keep_num``-th loss picks
    the branch, and the rank's selected losses are summed over the global
    count of the selection. The top ``keep_num`` are those of JAX's
    ``sort(...)[::-1]``: ties are taken from the end of the global batch.
    The shares of the ranks sum to the global loss. ``layout``: (data,
    spatial) sizes of a height-sharded mesh, whose rank d·S + s holds
    band s of data shard d: the gathered losses are put in the global
    batch's order (image, row, column) before the sort."""
    loss, valid = _per_pixel_ce(logits, labels, ignore_index)
    flat = torch.where(valid.reshape(-1), loss.reshape(-1), -torch.inf)
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat.detach().contiguous(), group=group)
    everything = torch.cat(parts)
    if layout is not None:
        data, bands = layout
        b = logits.shape[0]
        everything = everything.view(data, bands, b, -1).transpose(
            1, 2).reshape(-1)
    order = torch.sort(everything, stable=True).indices.flip(0)
    sorted_desc = everything[order]
    k = min(keep_num, everything.numel() - 1)
    kth = sorted_desc[k]

    above = flat > threshold
    n_above = (sorted_desc > threshold).sum().float().clamp_min(1.0)
    in_topk = torch.zeros_like(everything, dtype=torch.bool)
    in_topk[order[:k]] = True
    rank = dist.get_rank(group)
    if layout is not None:
        mine = in_topk.view(data, b, bands, -1)[
            rank // bands, :, rank % bands].reshape(-1)
    else:
        mine = in_topk[rank * flat.numel():(rank + 1) * flat.numel()]
    topk = mine & torch.isfinite(flat)
    n_topk = torch.isfinite(sorted_desc[:k]).sum().float().clamp_min(1.0)

    share_above = torch.where(above, flat, 0.0).sum() / n_above
    share_topk = torch.where(topk, flat, 0.0).sum() / n_topk
    return torch.where(kth > threshold, share_above, share_topk)


def check_per_replica_batch(batch_size: int, world: int) -> None:
    """Per-replica BN shards the batch over the ranks: refuse a ragged
    shard (JAX mesh.py:335-341)."""
    if batch_size % world:
        raise SystemExit(
            f"--sync_bn False needs --batch_size {batch_size} divisible "
            f"by the data-mesh size {world} (shard_map shards the batch)")


def _float_buffers(module: nn.Module) -> List[torch.Tensor]:
    return [b for b in module.buffers() if b.is_floating_point()]


@contextlib.contextmanager
def rank0_buffers(module: nn.Module, group=None):
    """Inside, ``module``'s floating buffers (BN running statistics) hold
    rank 0's values, copied in place (a captured eval graph still reads
    them); on exit each rank's own come back. The per-replica mode's
    evaluation reads shard 0's statistics, as JAX's ``untile_state``
    (mesh.py:327-332)."""
    buffers = _float_buffers(module)
    own = [b.clone() for b in buffers]
    if buffers:
        flat = torch.cat([b.reshape(-1) for b in buffers])
        dist.broadcast(flat, 0, group=group)
        torch._foreach_copy_(
            buffers, [f.view_as(b) for f, b in
                      zip(flat.split([b.numel() for b in buffers]), buffers)])
    try:
        yield module
    finally:
        if buffers:
            torch._foreach_copy_(buffers, own)


def untile_state(module: nn.Module, group=None) -> dict:
    """``module``'s state dict with rank 0's BN statistics (JAX
    ``untile_state``: the export and checkpoint view of a per-replica
    state), on the CPU."""
    with rank0_buffers(module, group):
        return {k: v.detach().to("cpu", copy=True)
                for k, v in module.state_dict().items()}


def make_sharded_train_step(model, optimizer, group=None, *,
                            num_classes: int, sync_bn: bool = True,
                            ohem: Optional[dict] = None, accumulator=None,
                            amp_dtype: Optional[torch.dtype] = None,
                            ignore_index: int = 255,
                            ce: Callable = cross_entropy_upsampled,
                            spatial=None):
    """step(images, labels) on this rank's rows of the global batch ->
    the global loss as a detached device scalar, equal on every rank
    (JAX mesh.py:162-247; the single-device step is
    ``train/supervised.py::make_train_step``). ``sync_bn`` converts the
    model's BN layers in place (``convert_sync_batchnorm``); the
    optimizer keeps its parameters. ``accumulator``: the
    ``GradientAccumulator`` over ``optimizer`` (``--iter_size``), fed the
    reduced gradients of each mini-step. ``spatial``: the height-sharded
    mesh over the default group (``parallel/spatial.py``); the images and
    labels are this rank's band, and the model is converted in place
    (``SpatialMesh.convert``)."""
    layout = None
    if spatial is not None:
        if not sync_bn or group is not None:
            raise ValueError("the spatial mesh takes sync BN over the "
                             "default group")
        spatial.convert(model)
        layout = (spatial.data_size, spatial.spatial_size)
    elif sync_bn:
        convert_sync_batchnorm(model, group)
    reducer = Reducer(group, sync_bn=sync_bn, num_classes=num_classes,
                      ignore_index=ignore_index)
    global_ohem = sync_bn and ohem is not None
    loss_fn = make_supervised_loss(
        model, ohem=ohem, ignore_index=ignore_index, amp_dtype=amp_dtype,
        ce=ce, ohem_loss=(functools.partial(sync_ohem_cross_entropy,
                                            group=group, layout=layout)
                          if global_ohem else ohem_cross_entropy),
        spatial=spatial)

    def step(images, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(images, labels)
        share = (loss if global_ohem or spatial is not None
                 else loss * reducer.ce_share(labels))
        share.backward()
        reducer.grads(optimizer)
        if accumulator is None:
            optimizer.step()
        else:
            accumulator.step()
        return reducer.total([share])[0]

    return step


def make_sharded_da_step(g, d, g_opt, d_opt, group=None, *,
                         num_classes: int, lambda_adv: float,
                         d_head: int = 0, sync_bn: bool = True,
                         step_mode: str = "interleaved",
                         amp_dtype: Optional[torch.dtype] = None,
                         ignore_index: int = 255,
                         ce: Callable = cross_entropy_upsampled,
                         spatial=None):
    """The 4-phase DA step on this rank's rows of the source and target
    batches (JAX mesh.py:250-324): ``train/adversarial.py::make_da_step``
    with this group's ``Reducer`` at its reduce points; ``sync_bn``
    converts G's and D's BN layers in place. The metrics are the global
    batch's, equal on every rank. ``spatial``: as
    ``make_sharded_train_step``'s; D's BN syncs over the world and D runs
    banded (``SpatialMesh.discriminator``)."""
    if spatial is not None:
        if not sync_bn or group is not None:
            raise ValueError("the spatial mesh takes sync BN over the "
                             "default group")
        spatial.convert(g)
        convert_sync_batchnorm(d)
    elif sync_bn:
        convert_sync_batchnorm(g, group)
        convert_sync_batchnorm(d, group)
    reducer = Reducer(group, sync_bn=sync_bn, num_classes=num_classes,
                      ignore_index=ignore_index)
    return make_da_step(g, d, g_opt, d_opt, lambda_adv=lambda_adv,
                        ignore_index=ignore_index, d_head=d_head,
                        step_mode=step_mode, amp_dtype=amp_dtype, ce=ce,
                        reducer=reducer, spatial=spatial)

