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

On a card the step is one replayed CUDA graph (``make_train_step``): the
host's enqueue of its ~900 kernels paced the step as much as the card did.
Each batch shape (at most ``MAX_GRAPHS``) gets static input slots. Its
first step is a real eager step on a side stream, which makes cuDNN's
plans, the kernels' taps and libraries and the optimizer's state; its
second captures ``zero_grad(set_to_none=True)``, the forward, the three
CE heads, the backward and ``optimizer.step()`` into a graph and replays
it once; every later step copies the batch into the slots and replays.
Each call applies one update. The graph reads the parameters, the BN
statistics and the optimizer's state where they live, so a checkpoint
restored into them in place needs nothing; where the optimizer's
settings (the learning rate ``set_learning_rate`` changes every epoch)
or the place of those tensors change (``_fingerprint``), the shape takes
an eager step again and is captured anew. Under bf16 or fp16 autocast the
graph's first op makes the images ``torch.channels_last``: cuDNN then
runs every convolution in NHWC without transposing activations, and BN,
pooling, the depthwise convolutions and ``cat`` take their NHWC kernels
(BN's NCHW kernels reduce one channel a block). The parameters stay
NCHW, and the heads' logits reach the fused CE contiguous, as before.
Where ``eager_reason`` gives a reason (the CPU, OHEM, an accumulator, an
eval-mode model, an optimizer that cannot be captured, a third shape),
the step is the eager NCHW step.

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
import itertools
import time
from typing import Callable, Dict, List, Optional

import torch

from ..data.pipeline import device_prefetch
from ..ops.cuda import fused_ce as _fused_ce
from ..ops.cuda import upsample_argmax as _upsample_argmax
from ..ops.cuda.fused_ce import cross_entropy_upsampled
from ..ops.losses import ohem_cross_entropy
from ..ops.schedules import PolyLR
from ..utils.logging_util import count, end_step, span
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
    on the band's row window over the global valid count). Autocast keeps
    no cache of cast weights: a forward uses each weight once, and a
    captured step (``make_train_step``) must cast the live weights."""

    def autocast(device_type):
        if amp_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(device_type, dtype=amp_dtype,
                              cache_enabled=False)

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


#: the batch shapes a step keeps a captured graph for; a step of another
#: shape runs eagerly
MAX_GRAPHS = 2
#: the kernels' launch counters a captured step holds launches of, by
#: kernel
_LAUNCH_COUNTERS = {"fused_ce_fwd": (_fused_ce, "FWD_LAUNCHES"),
                    "fused_ce_bwd": (_fused_ce, "BWD_LAUNCHES"),
                    "upsample_argmax": (_upsample_argmax, "LAUNCHES")}
#: the types of an optimizer group's settings that a capture bakes in
_SETTINGS = (bool, int, float, str, tuple, type(None))


def eager_reason(*, cuda: bool, ohem: bool, accumulator: bool,
                 training: bool, capturable: bool, known: bool, shapes: int,
                 warmed: bool) -> Optional[str]:
    """Why a train step runs eagerly, or None where it replays its graph
    (module docstring). ``cuda``: the images are CUDA tensors; ``ohem``,
    ``accumulator``: the step has them; ``training``: the model is in
    train mode; ``capturable``: the optimizer's step can be captured
    (``_capturable``); ``known``: the batch's shape has a graph;
    ``shapes``: the shapes that have one; ``warmed``: the shape took its
    eager first step under the optimizer's present settings and state
    (``_StepGraph.warmed``)."""
    if not cuda:
        return "cpu"
    if ohem:
        return "ohem"
    if accumulator:
        return "accumulator"
    if not training:
        return "eval"
    if not capturable:
        return "optimizer"
    if not known and shapes >= MAX_GRAPHS:
        return "shapes"
    if not warmed:
        return "warmup"
    return None


def _capturable(optimizer) -> bool:
    """``optimizer.step()`` can be captured: no group says
    ``capturable=False`` (Adam and RMSprop do by default: their step
    counts are host tensors)."""
    return all(g.get("capturable", True) for g in optimizer.param_groups)


def _launches() -> Dict[str, int]:
    return {name: getattr(module, attr)
            for name, (module, attr) in _LAUNCH_COUNTERS.items()}


def _count_launches(kind: str, launches: Dict[str, int]) -> None:
    for name, n in launches.items():
        if n:
            count(f"train.{kind}_launches.{name}", n)


def _fingerprint(tensors, optimizer) -> tuple:
    """What a captured step bakes in: each optimizer group's settings (its
    learning rate among them), and where ``tensors`` (the model's
    parameters and buffers) and the optimizer's state live."""
    groups = tuple(tuple(sorted((k, v) for k, v in g.items()
                                if k != "params" and isinstance(v, _SETTINGS)))
                   for g in optimizer.param_groups)
    state = (t for s in optimizer.state.values() for t in s.values()
             if isinstance(t, torch.Tensor))
    return groups, tuple(t.data_ptr() for t in itertools.chain(tensors, state))


class _StepGraph:
    """One batch shape's static input slots and the step captured over
    them."""

    def __init__(self, images: torch.Tensor, labels: torch.Tensor):
        self.images = torch.empty_like(images,
                                       memory_format=torch.contiguous_format)
        self.labels = torch.empty_like(labels,
                                       memory_format=torch.contiguous_format)
        #: the model's parameters and buffers at the shape's eager first
        #: step, and ``_fingerprint`` after it; None: the next step of the
        #: shape is that eager step
        self.tensors: List[torch.Tensor] = []
        self.fingerprint: Optional[tuple] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: the graph was captured before the last eager first step, or
        #: there is none: capture (again) before the next replay
        self.stale = True
        self.loss: Optional[torch.Tensor] = None
        #: the launches the graph holds, by kernel
        self.launches: Dict[str, int] = {}

    def load(self, images: torch.Tensor, labels: torch.Tensor) -> None:
        self.images.copy_(images)
        self.labels.copy_(labels)

    def warmed(self, optimizer) -> bool:
        """The shape took its eager first step under the optimizer's
        present settings and state."""
        return (self.fingerprint is not None
                and self.fingerprint == _fingerprint(self.tensors, optimizer))

    def warm_up(self, body: Callable, model, optimizer) -> torch.Tensor:
        """One real step over the slots on a side stream: cuDNN's plans,
        the fused CE's taps, the kernels' libraries and the optimizer's
        state are made here, outside any capture. A graph captured
        before it is stale."""
        current = torch.cuda.current_stream(self.images.device)
        side = torch.cuda.Stream(self.images.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            loss = body(self.images, self.labels)
        current.wait_stream(side)
        self.tensors = [*model.parameters(), *model.buffers()]
        self.fingerprint = _fingerprint(self.tensors, optimizer)
        self.stale = True
        return loss

    def capture(self, body: Callable) -> None:
        """``body`` over the slots into a graph, in the memory pool of the
        graph it replaces, if any. The wrappers count their calls in the
        capture, which launched nothing, and a replay passes through no
        wrapper: the counters ``train.captured_launches.<kernel>`` and
        ``train.replayed_launches.<kernel>`` keep both, so a run's
        launches are its wrapper's rise, less the first, plus the second
        (as ``train/evaluate.py``'s ``CAPTURED_LAUNCHES`` and
        ``REPLAYED_LAUNCHES``). ``thread_local``: the loader's threads may
        call CUDA (``pin_memory``) meanwhile. A failed capture raises."""
        pool = None if self.graph is None else self.graph.pool()
        self.loss = None
        graph = torch.cuda.CUDAGraph()
        before = _launches()
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            self.loss = body(self.images, self.labels)
        self.launches = {k: n - before[k] for k, n in _launches().items()}
        _count_launches("captured", self.launches)
        self.graph, self.stale = graph, False
        count("train.graph_captures")

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        _count_launches("replayed", self.launches)
        return self.loss.clone()


def make_train_step(model, optimizer, *, accumulator=None,
                    ohem: Optional[dict] = None, ignore_index: int = 255,
                    amp_dtype: Optional[torch.dtype] = None,
                    ce: Callable = cross_entropy_upsampled):
    """step(images, labels) -> the loss as a detached device scalar (JAX
    supervised.py:86-113). The model must be in train mode.
    ``accumulator``: a ``GradientAccumulator`` over ``optimizer``; the step
    is then one mini-step (JAX cli.py:719-722). On CUDA the step replays a
    captured graph over ``torch.channels_last`` activations where
    ``eager_reason`` finds none (module docstring).

    Spans (``utils/logging_util.py``): an eager step's phases
    ``train.forward``, ``train.backward`` and ``train.optimizer``; a
    graphed step's ``train.replay`` (the slot copies and the replay) and,
    once a graph, ``train.capture``. Counters, on CUDA, one a step:
    ``train.graph_replays`` or ``train.eager_steps.<eager_reason>``; one a
    capture: ``train.graph_captures``; the launches a graph holds, by
    kernel, at its capture ``train.captured_launches.<kernel>`` and at
    each replay ``train.replayed_launches.<kernel>``
    (``_StepGraph.capture``)."""
    loss_fn = make_supervised_loss(model, ohem=ohem,
                                   ignore_index=ignore_index,
                                   amp_dtype=amp_dtype, ce=ce)
    channels_last = amp_dtype in (torch.bfloat16, torch.float16)
    graphs: Dict[tuple, _StepGraph] = {}

    def phases(images, labels):
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
        return loss.detach()

    def graph_body(images, labels):
        if channels_last:
            images = images.contiguous(memory_format=torch.channels_last)
        return phases(images, labels)

    def graphed(held, reason, images, labels):
        """The step of a shape that is taking its eager first step
        (``reason`` "warmup") or replays its graph, captured first where
        it has none under the present state."""
        if reason == "warmup":
            held.load(images, labels)
            return held.warm_up(graph_body, model, optimizer)
        if held.stale:
            with span("train.capture"):
                held.capture(graph_body)
        with span("train.replay"):
            held.load(images, labels)
            return held.replay()

    def step(images, labels):
        cuda = images.device.type == "cuda"
        key = (tuple(images.shape), images.dtype, tuple(labels.shape),
               labels.dtype)
        held = graphs.get(key)
        reason = eager_reason(
            cuda=cuda, ohem=ohem is not None,
            accumulator=accumulator is not None, training=model.training,
            capturable=_capturable(optimizer),
            known=held is not None, shapes=len(graphs),
            warmed=held is not None and held.warmed(optimizer))
        if reason is None or reason == "warmup":
            held = graphs.setdefault(key, held or _StepGraph(images, labels))
            loss = graphed(held, reason, images, labels)
        else:
            loss = phases(images, labels)
        if cuda:
            count("train.graph_replays" if reason is None
                  else f"train.eager_steps.{reason}")
        end_step()
        return loss

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
