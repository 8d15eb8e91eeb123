"""Adversarial domain-adaptation trainer (reference train.py:134-299).

Counterpart of ``dasemanticsegmentationaml_tpu/train/adversarial.py``. The
reference's step per batch (train.py:192-262), in its own module-call
order, with torch's autograd as the reference has it:

  1. G-seg : the heads of G(src) (train mode); the three heads' CE summed;
             backward; SGD step (train.py:211-221)
  2. G-adv : the heads of G'(tgt); D(softmax(upsampled d_head head)) with D
             in train mode and its parameters frozen (its BN statistics
             still update, as a train-mode module's do); lambda_adv *
             BCE against the source label 0; backward; SGD step
             (train.py:207-208, 223-237)
  3. D-src : D(softmax of phase 1's head, detached) -> BCE vs 0 -> Adam
             step (train.py:243-254)
  4. D-tgt : D(softmax of phase 2's head, detached) -> BCE vs 1 -> Adam
             step (train.py:256-262)

``step_mode='combined'`` is the NNI trial's ordering instead (reference
train_nni.py:105-163; JAX :220-301): one zero_grad per optimizer, the four
backwards accumulated with both G forwards at the initial weights and
both D forwards at the old D, then one step per optimizer. BN statistics
update in module-call order in both modes: G on source then target, D on
adv, then src, then tgt (JAX :55-57).

Heads: ``d_head`` (0 = the main head, 2 = out32 as the NNI variant feeds)
is upsampled with align_corners and goes through ``cross_entropy_ignore``,
because D needs its full-resolution map; the other two go through the
fused upsample+CE (``ops/cuda/fused_ce.py``, a CUDA kernel on the card).
The per-head sum keeps the reference's order (JAX :142-147).

Gradients are zeroed with ``zero_grad(set_to_none=False)``: the JAX step
pins the torch<2.0 semantics the reference ran (JAX :26-33), under which
the aux heads, which phase 2 does not reach, receive zero gradients there
and SGD still applies momentum and weight decay to them. torch 2.x's
default ``set_to_none=True`` would skip them.

The epoch loop reproduces the reference's compounding poly LR for G and D
(train.py:185-186), the NNI trial's LR dataflow under ``lr_mode=
'nni_faithful'`` (JAX :339-344), one host readback per epoch, the
``iter = ..., loss_seg = ... loss_D1 = ...`` line, ``GTA5_<step>.pth`` /
``GTA5_<step>_D1.pth`` with ``module.`` prefixes (train.py:280-283), and
``best.pth`` + ``best_D1.pth`` (JAX :448-450). Each checkpoint carries its
optimizer and the epoch, D's under the alias ``latest_D1`` (JAX
:424-450), so ``--resume`` restores G, D and both optimizers together; a
resumed run's best mIoU and step counter start again from 0, as in JAX.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..data.pipeline import device_prefetch
from ..ops.cuda.fused_ce import cross_entropy_upsampled
from ..ops.losses import _per_pixel_ce, bce_with_logits, cross_entropy_ignore
from ..ops.resize import resize_bilinear_align_corners
from ..ops.schedules import ConstantLR, PolyLR
from .optim import set_learning_rate

SOURCE_LABEL = 0.0  # reference train.py:181
TARGET_LABEL = 1.0  # reference train.py:182


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """requires_grad False for the module's parameters (train.py:207-208),
    restored on exit; a train-mode forward still updates its BN stats."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def make_da_step(g, d, g_opt, d_opt, *, lambda_adv: float,
                 ignore_index: int = 255, d_head: int = 0,
                 step_mode: str = "interleaved",
                 amp_dtype: Optional[torch.dtype] = None,
                 ce: Callable = cross_entropy_upsampled, reducer=None,
                 spatial=None):
    """step(src_images, src_labels, tgt_images) -> metrics, a dict of
    detached device scalars: ``loss`` (the seg loss), ``loss_D1`` (lambda *
    adversarial BCE), ``loss_G`` (their sum) and ``loss_adv`` (D's two
    BCEs) (JAX :212-217). G and D must be in train mode; the optimizers'
    learning rates are set by the caller.

    ``reducer``: a data-parallel rank's ``parallel/mesh.py::Reducer``.
    Each loss is then backpropagated as the rank's share of the global
    one, the gradients are summed over the ranks at JAX's reduce points
    (``reduce`` :108-110: before each optimizer step of the interleaved
    step, before the two steps of the combined one) and the metrics are
    the global batch's.

    ``spatial``: the height-sharded mesh (``parallel/spatial.py``), with
    G converted and D's BN synced by the caller: the images and labels
    are this rank's band, G and D run banded, and every loss is already
    the band's share of the global one: each head's CE over the global
    valid count (the fused kernel's row window, the d_head head's plain
    CE on its band of the upsample), each BCE over the element count of
    D's global output (D's bands are unequal)."""
    if step_mode not in ("interleaved", "combined"):
        raise ValueError(f"unknown DA step_mode: {step_mode!r}")

    def backward(loss, share):
        """Backpropagate ``loss``, as the rank's share of it under a
        reducer; returns what was backpropagated."""
        if share is not None:
            loss = loss * share
        loss.backward()
        return loss

    def reduce(optimizer):
        if reducer is not None:
            reducer.grads(optimizer)

    def shares(src_labels):
        """(the seg loss's share, the BCEs' share) of this rank: None
        where the loss is its share already (spatial)."""
        if reducer is None or spatial is not None:
            return None, None
        return reducer.ce_share(src_labels), reducer.mean_share

    def autocast(device_type):
        if amp_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(device_type, dtype=amp_dtype)

    def banded():
        return (spatial.banded() if spatial is not None
                else contextlib.nullcontext())

    def heads(images):
        """G's heads at their strides, and the d_head head upsampled to the
        input size in fp32 or wider (what D and its CE see)."""
        with autocast(images.device.type), banded():
            feats = g.features(images)
            head = feats[d_head]
            head = head.to(torch.promote_types(head.dtype, torch.float32))
            hw = tuple(images.shape[2:])
            up = (spatial.resize_band(head, hw) if spatial is not None
                  else resize_bilinear_align_corners(head, hw))
        return feats, up

    def seg_loss(feats, up, labels):
        hw = tuple(labels.shape[1:])
        if spatial is not None:
            n = spatial.valid_count(labels, up.shape[1], ignore_index)
            losses = [_per_pixel_ce(up, labels, ignore_index)[0].sum() / n
                      if i == d_head else
                      spatial.band_ce(ce, f, labels, ignore_index, n)
                      for i, f in enumerate(feats)]
        else:
            losses = [cross_entropy_ignore(up, labels, ignore_index)
                      if i == d_head else
                      ce(f.contiguous(), labels, hw, ignore_index)
                      for i, f in enumerate(feats)]
        return losses[0] + losses[1] + losses[2]

    def d_bce(probs, label):
        count = None
        with autocast(probs.device.type), banded():
            if spatial is not None:
                out, rows = spatial.discriminator(d, probs)
                count = spatial.count_of(out, rows)
            else:
                out = d(probs)
        return bce_with_logits(out, label, count)

    def zero_grad():
        g_opt.zero_grad(set_to_none=False)
        d_opt.zero_grad(set_to_none=False)

    def interleaved(src_images, src_labels, tgt_images):
        seg_share, mean_share = shares(src_labels)
        zero_grad()
        # phase 1: G segmentation update on source
        feats, up_src = heads(src_images)
        loss = backward(seg_loss(feats, up_src, src_labels), seg_share)
        reduce(g_opt)
        g_opt.step()
        # phase 2: G adversarial update on target, D frozen
        _, up_tgt = heads(tgt_images)
        g_opt.zero_grad(set_to_none=False)
        with _frozen(d):
            loss_d1 = backward(d_bce(F.softmax(up_tgt, dim=1), SOURCE_LABEL)
                               * lambda_adv, mean_share)
        reduce(g_opt)
        g_opt.step()
        # phases 3 and 4: D on the detached maps (train.py:243-244)
        probs_src = F.softmax(up_src.detach(), dim=1)
        probs_tgt = F.softmax(up_tgt.detach(), dim=1)
        loss_src = backward(d_bce(probs_src, SOURCE_LABEL), mean_share)
        reduce(d_opt)
        d_opt.step()
        loss_tgt = d_bce(probs_tgt, TARGET_LABEL)
        d_opt.zero_grad(set_to_none=False)
        loss_tgt = backward(loss_tgt, mean_share)
        reduce(d_opt)
        d_opt.step()
        return loss, loss_d1, loss_src, loss_tgt

    def combined(src_images, src_labels, tgt_images):
        seg_share, mean_share = shares(src_labels)
        zero_grad()
        with _frozen(d):
            feats, up_src = heads(src_images)
            loss = backward(seg_loss(feats, up_src, src_labels), seg_share)
            _, up_tgt = heads(tgt_images)
            loss_d1 = backward(d_bce(F.softmax(up_tgt, dim=1), SOURCE_LABEL)
                               * lambda_adv, mean_share)
        reduce(g_opt)
        loss_src = backward(d_bce(F.softmax(up_src.detach(), dim=1),
                                  SOURCE_LABEL), mean_share)
        loss_tgt = backward(d_bce(F.softmax(up_tgt.detach(), dim=1),
                                  TARGET_LABEL), mean_share)
        reduce(d_opt)
        g_opt.step()
        d_opt.step()
        return loss, loss_d1, loss_src, loss_tgt

    run = interleaved if step_mode == "interleaved" else combined

    def step(src_images, src_labels, tgt_images):
        losses = run(src_images, src_labels, tgt_images)
        if reducer is not None:
            loss, loss_d1, loss_src, loss_tgt = reducer.total(list(losses))
        else:
            loss, loss_d1, loss_src, loss_tgt = (t.detach() for t in losses)
        return {"loss": loss, "loss_D1": loss_d1, "loss_G": loss + loss_d1,
                "loss_adv": loss_src + loss_tgt}

    return step


def train_da(args, g, d, g_opt, d_opt, loader_source, loader_target, *,
             prepare_source, prepare_target, evaluate_fn, da_step: Callable,
             writer=None, logger=None,
             checkpoint_fn: Optional[Callable] = None,
             lr_mode: str = "reference", profiler=None,
             report_fn: Optional[Callable] = None) -> float:
    """Epoch loop (JAX :311-457; reference train.py:176-299); returns the
    best validation mIoU.

    prepare_*(batch, epoch, it) -> (images, labels) on the device (the
    epoch and step key the source batch's augmentation), fetched two ahead
    under ``args.fetch_timeout``'s watchdog (JAX :384-385); profiler: its
    ``step()`` is called after each step; evaluate_fn(g) ->
    (precision, miou), called with G in eval mode and G restored to train
    mode after; checkpoint_fn(model, name, dataparallel_prefix=False,
    optimizer=, model=, epoch=) (``utils/checkpoint.py``).
    lr_mode: 'reference' (each optimizer compounds its own poly schedule)
    or 'nni_faithful' (G compounds ``learning_rate_D``'s schedule, D keeps
    ``learning_rate_D``: the NNI trial's actual dataflow, JAX :326-333).
    report_fn(epoch, miou): called after every validation, the HPO trial's
    hook (JAX :436-437)."""
    if lr_mode == "nni_faithful":
        sched_g = PolyLR(args.learning_rate_D, args.num_epochs,
                         mode="compounding")
        sched_d = ConstantLR(args.learning_rate_D)
    elif lr_mode == "reference":
        sched_g = PolyLR(args.learning_rate, args.num_epochs,
                         mode="compounding")
        sched_d = PolyLR(args.learning_rate_D, args.num_epochs,
                         mode="compounding")
    else:
        raise ValueError(f"unknown lr_mode: {lr_mode!r}")
    # a resumed run continues the compounded schedule (JAX :353-356)
    sched_g.fast_forward(args.epoch_start_i)
    sched_d.fast_forward(args.epoch_start_i)
    max_miou = 0.0
    step_count = 0
    max_steps = args.max_steps_per_epoch
    g.train()
    d.train()

    for epoch in range(args.epoch_start_i, args.num_epochs):
        lr_g, lr_d = sched_g(epoch), sched_d(epoch)
        set_learning_rate(g_opt, lr_g)
        set_learning_rate(d_opt, lr_d)
        loader_source.set_epoch(epoch)
        loader_target.set_epoch(epoch)
        metrics = []
        n_images = 0
        t0 = time.time()

        def prepared_batches():
            for it, (src, tgt) in enumerate(zip(loader_source,
                                                loader_target)):
                if max_steps is not None and it >= max_steps:
                    break
                src_images, src_labels = prepare_source(src, epoch, it)
                tgt_images, _ = prepare_target(tgt, epoch, it)
                yield src_images, src_labels, tgt_images

        for src_images, src_labels, tgt_images in device_prefetch(
                prepared_batches(),
                transfer_timeout=args.fetch_timeout,
                device=next(g.parameters()).device):
            m = da_step(src_images, src_labels, tgt_images)
            if profiler is not None:
                profiler.step()
            metrics.append(torch.stack([m["loss"], m["loss_G"],
                                        m["loss_adv"]]))
            n_images += src_images.shape[0]
            step_count += 1
        # one readback per epoch (JAX :399-405)
        host = torch.stack(metrics).cpu().tolist() if metrics else []
        dt = time.time() - t0
        mean_g = sum(r[1] for r in host) / len(host) if host else 0.0
        mean_d = sum(r[2] for r in host) / len(host) if host else 0.0
        if writer is not None:
            first_step = step_count - len(host) + 1
            for i, (loss, loss_g, loss_adv) in enumerate(host):
                writer.add_scalar("loss_step", loss, first_step + i)
                writer.add_scalar("loss_G", loss_g, first_step + i)
                writer.add_scalar("loss_adv", loss_adv, first_step + i)
        print("iter = {0:1d}/{1}, loss_seg = {2:.3f} loss_D1 = {3:.3f}"
              .format(epoch, args.num_epochs, mean_g, mean_d))
        if logger is not None:
            logger.log(epoch=epoch, lr_g=lr_g, lr_d=lr_d, loss_seg=mean_g,
                       loss_adv=mean_d,
                       images_per_sec=n_images / max(dt, 1e-9))

        if epoch % args.checkpoint_step == 0 and epoch != 0 \
                and checkpoint_fn is not None:
            # train.py:280-283: module.-prefixed, named by the step flag
            checkpoint_fn(g, f"GTA5_{args.checkpoint_step}",
                          dataparallel_prefix=True, optimizer=g_opt,
                          epoch=epoch)
            checkpoint_fn(d, f"GTA5_{args.checkpoint_step}_D1",
                          dataparallel_prefix=True, optimizer=d_opt,
                          model="discriminator", epoch=epoch)

        if epoch % args.validation_step == 0 and epoch != 0:
            g.eval()
            try:
                precision, miou = evaluate_fn(g)
            finally:
                g.train()
            if report_fn is not None:
                report_fn(epoch, miou)
            if miou > max_miou:
                max_miou = miou
                if checkpoint_fn is not None:
                    # both nets: a best save moves G's 'latest' and the
                    # marker, so D must move with it (JAX :440-450)
                    checkpoint_fn(g, "best", optimizer=g_opt, epoch=epoch)
                    checkpoint_fn(d, "best_D1", optimizer=d_opt,
                                  model="discriminator", epoch=epoch)
            if writer is not None:
                writer.add_scalar("epoch/precision_val", precision, epoch)
                writer.add_scalar("epoch/miou val", miou, epoch)

    n_d_params = sum(p.numel() for p in d.parameters())
    print("The discriminator has: ", n_d_params)  # train.py:295-299
    return max_miou
