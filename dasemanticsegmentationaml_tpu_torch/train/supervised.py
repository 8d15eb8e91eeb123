"""Supervised trainer (reference train.py:63-120).

Counterpart of ``dasemanticsegmentationaml_tpu/train/supervised.py``. One
step: zero the gradients, the forward under bf16 ``torch.autocast`` (or
fp32), the three heads' summed CE(ignore=255), backward, optimizer step.
The reference's AMP GradScaler (train.py:65,83,91-93) has no counterpart:
bf16 has fp32's exponent range, so no loss scaling is needed. BN runs in
train mode (stock ``nn.BatchNorm2d``: biased batch variance to normalise,
unbiased into the running variance, JAX ops/norm.py:72-97).

With ``--iter_size k > 1`` the optimizer steps through a
``GradientAccumulator`` (``train/optim.py``, optax ``MultiSteps``): each
mini-step is one call of the step, and the parameters move at every k-th.

The epoch loop keeps the reference's bookkeeping: the standard poly LR per
epoch (train.py:71), ``latest`` every ``checkpoint_step`` epochs,
validation and ``best`` every ``validation_step`` (train.py:106-120), and
its TensorBoard names (loss_step / epoch/loss_epoch_train /
epoch/precision_val / 'epoch/miou val'). Each checkpoint carries the
epoch, the optimizer and the accumulator (JAX supervised.py:189-199), for
``--resume``. A resumed run starts at ``args.epoch_start_i``; its best
mIoU and TensorBoard step counter start again from 0, as in JAX. The step
returns its loss (one per mini-step) as a device tensor; the losses are
read back once per epoch (JAX supervised.py:169-187), so no step waits
for the card.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch

from ..data.pipeline import device_prefetch
from ..ops.cuda.fused_ce import cross_entropy_upsampled
from ..ops.losses import ohem_cross_entropy
from ..ops.schedules import PolyLR
from ..utils.logging_util import end_step, span
from .optim import set_learning_rate


def make_supervised_loss(model, *, ohem: Optional[dict] = None,
                         ignore_index: int = 255,
                         amp_dtype: Optional[torch.dtype] = None,
                         ce: Callable = cross_entropy_upsampled,
                         ohem_loss: Callable = ohem_cross_entropy,
                         spatial=None):
    """(images, labels) -> the summed loss of the three heads (JAX
    supervised.py:38-83).

    Cross-entropy: ``features`` gives the heads at their native strides
    and ``ce`` (the fused upsample+CE, a CUDA kernel on the card) takes
    each to the label size. ``ohem``: {'threshold', 'keep_num'} runs the
    full forward (upsampled heads) and ``ohem_loss`` (``ohem_cross_entropy``;
    a data-parallel sync step passes its global form,
    ``parallel/mesh.py::sync_ohem_cross_entropy``), as JAX does.
    ``amp_dtype``: run the model under ``torch.autocast``; the loss
    is fp32 either way. ``spatial``: a converted model's
    ``parallel/spatial.py::SpatialMesh``; ``images`` and ``labels`` are
    then this rank's band, the forward runs banded, and each head's CE is
    the band's share of the global mean (``SpatialMesh.band_ce``: ``ce``
    on the band's row window over the global valid count)."""

    def autocast(device_type):
        if amp_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(device_type, dtype=amp_dtype)

    def loss_fn(images, labels):
        with autocast(images.device.type), \
                (spatial.banded() if spatial is not None
                 else contextlib.nullcontext()):
            heads = model(images) if ohem is not None \
                else model.features(images)
        if ohem is not None:
            losses = [ohem_loss(o, labels, ohem["threshold"],
                                ohem["keep_num"], ignore_index)
                      for o in heads]
        elif spatial is not None:
            n_valid = spatial.valid_count(labels, heads[0].shape[1],
                                          ignore_index)
            losses = [spatial.band_ce(ce, f, labels, ignore_index, n_valid)
                      for f in heads]
        else:
            hw = tuple(images.shape[2:])
            losses = [ce(f.contiguous(), labels, hw, ignore_index)
                      for f in heads]
        return losses[0] + losses[1] + losses[2]

    return loss_fn


def make_train_step(model, optimizer, *, accumulator=None,
                    ohem: Optional[dict] = None, ignore_index: int = 255,
                    amp_dtype: Optional[torch.dtype] = None,
                    ce: Callable = cross_entropy_upsampled):
    """step(images, labels) -> the loss as a detached device scalar (JAX
    supervised.py:86-113). The model must be in train mode.
    ``accumulator``: a ``GradientAccumulator`` over ``optimizer``; the step
    is then one mini-step (JAX cli.py:719-722). Its phases are the spans
    ``train.forward``, ``train.backward`` and ``train.optimizer``
    (``utils/logging_util.py``)."""
    loss_fn = make_supervised_loss(model, ohem=ohem,
                                   ignore_index=ignore_index,
                                   amp_dtype=amp_dtype, ce=ce)

    def step(images, labels):
        with span("train.forward"):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(images, labels)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            if accumulator is None:
                optimizer.step()
            else:
                accumulator.step()
        end_step()
        return loss.detach()

    return step


def train(args, model, optimizer, loader_train, *, prepare, evaluate_fn,
          train_step: Callable, writer=None, logger=None,
          checkpoint_fn: Optional[Callable] = None, profiler=None,
          accumulator=None, report_fn: Optional[Callable] = None):
    """Epoch loop with the reference's bookkeeping (JAX
    supervised.py:116-204; reference train.py:63-120).

    prepare(batch, epoch, it) -> (images, labels) on the device (the
    epoch and step key the batch's augmentation), fetched two ahead under
    ``args.fetch_timeout``'s watchdog (JAX supervised.py:161); profiler:
    its ``step()`` is called after each step; evaluate_fn(model) ->
    (precision, miou), called with the model in eval mode, which is
    restored to train mode afterwards (otherwise BN would either stay
    frozen or learn the val set); checkpoint_fn(model, name, optimizer=,
    accumulator=, epoch=) writes 'latest' / 'best' (``utils/checkpoint.
    py``); ``accumulator``: the ``GradientAccumulator`` the step uses, saved
    with the state; report_fn(epoch, miou): called after every validation,
    the HPO trial's hook (JAX supervised.py:195-196). Returns the best
    validation mIoU."""
    sched = PolyLR(args.learning_rate, args.num_epochs, mode="standard")
    max_miou = 0.0
    step_count = 0
    max_steps = args.max_steps_per_epoch
    model.train()

    for epoch in range(args.epoch_start_i, args.num_epochs):
        lr = sched(epoch)
        set_learning_rate(optimizer, lr)
        loader_train.set_epoch(epoch)
        losses = []
        n_images = 0
        t0 = time.time()

        def prepared_batches():
            for it, batch in enumerate(loader_train):
                if max_steps is not None and it >= max_steps:
                    break
                yield prepare(batch, epoch, it)

        for images, labels in device_prefetch(
                prepared_batches(),
                transfer_timeout=args.fetch_timeout,
                device=next(model.parameters()).device):
            losses.append(train_step(images, labels))
            if profiler is not None:
                profiler.step()
            n_images += images.shape[0]
            step_count += 1
        # one readback per epoch: a per-step .item() would wait for the
        # card every step and leave it idle while the host enqueues
        losses_host = (torch.stack(losses).cpu().tolist() if losses else [])
        dt = time.time() - t0
        loss_train_mean = (sum(losses_host) / len(losses_host)
                           if losses_host else 0.0)
        if writer is not None:
            first_step = step_count - len(losses_host) + 1
            for i, value in enumerate(losses_host):
                writer.add_scalar("loss_step", value, first_step + i)
            writer.add_scalar("epoch/loss_epoch_train", loss_train_mean,
                              epoch)
        if logger is not None:
            logger.log(epoch=epoch, lr=lr, loss=loss_train_mean,
                       images_per_sec=n_images / max(dt, 1e-9))
        print("loss for train : %f" % loss_train_mean)

        if epoch % args.checkpoint_step == 0 and epoch != 0 \
                and checkpoint_fn is not None:
            checkpoint_fn(model, "latest", optimizer=optimizer,
                          accumulator=accumulator, epoch=epoch)

        if epoch % args.validation_step == 0 and epoch != 0:
            model.eval()
            try:
                precision, miou = evaluate_fn(model)
            finally:
                model.train()
            if report_fn is not None:
                report_fn(epoch, miou)
            if miou > max_miou:
                max_miou = miou
                if checkpoint_fn is not None:
                    checkpoint_fn(model, "best", optimizer=optimizer,
                                  accumulator=accumulator, epoch=epoch)
            if writer is not None:
                writer.add_scalar("epoch/precision_val", precision, epoch)
                writer.add_scalar("epoch/miou val", miou, epoch)
    return max_miou
