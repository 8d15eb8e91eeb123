"""Supervised training: the port's ``make_train_step`` in a timed loop.

Set-up makes the state dict and the traffic's pool from the seed, builds
the port's BiSeNet, SGD over its trainable parameters and the step
(bf16 autocast, the fused CE), and takes the first ``check_steps`` steps
through the window's own feed and call (``prepare_batch`` and
``device_prefetch``, as ``train/supervised.py::train`` feeds them); the
optimizer's state after the first and the parameters after the last are
kept for the check. Then ``warmup_steps`` more, and the window.

After the window the program is freed and the reference takes the same
steps from the same state dict on the same batches (``check.py``).
"""

from __future__ import annotations

import time

import torch

from .. import check, flops, inputs, roofline
from ..reference import steps as R
from . import common


def program_steps(run, state, batches):
    """The port's model, optimizer and step (and its feed) on ``batches``,
    with ``run.fault`` planted: (model, optimizer, step, feed)."""
    from dasemanticsegmentationaml_tpu_torch.data.pipeline import prepare_batch
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.train.optim import make_optimizer
    from dasemanticsegmentationaml_tpu_torch.train.supervised import (
        make_train_step)

    c, dev = run.config, torch.device(run.device)
    amp = common.amp_dtype(c)
    g = common.program_g(state, dev)
    opt_c = c["optimizer"]
    opt = make_optimizer("sgd", trainable_parameters(g, False), opt_c["lr"],
                         momentum=opt_c["momentum"],
                         weight_decay=opt_c["weight_decay"])
    step = faulty(run.fault, make_train_step(g, opt, amp_dtype=amp), opt)

    def prepare(images, labels):
        return prepare_batch(images, labels, device=dev, remap=False,
                             dtype=amp or torch.float32)

    return g, opt, step, common.feed(batches, prepare, dev)


def faulty(fault, step, opt):
    """``step`` with a fault planted: "unchanged" (the optimizer never
    steps), "half_batch" (half of the batch left out, the mean over the
    rest), "lr_x10" (the optimizer steps ten times as far), or as it
    is."""
    if fault == "unchanged":
        opt.step = lambda *a, **k: None
    elif fault == "half_batch":
        def half(*tensors):
            return step(*(t[:t.shape[0] // 2] for t in tensors))
        return half
    elif fault == "lr_x10":
        for group in opt.param_groups:
            group["lr"] *= 10
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    return step


def opt_state(opt, key):
    """{key: tensor} a parameter of ``opt``, in its order (zeros where the
    optimizer holds none: it never stepped)."""
    return [{key: opt.state[p][key].detach().clone() if key in opt.state[p]
             else torch.zeros_like(p)}
            for group in opt.param_groups for p in group["params"]]


def first_steps(run, it, step, opt, n):
    """The check's steps: (losses, optimizer state after the first,
    parameters after the last)."""
    losses, opt1 = [], None
    for k in range(n):
        losses.append(step(*next(it)))
        if k == 0:
            opt1 = opt_state(opt, "momentum_buffer")
    params = [p.detach().clone() for group in opt.param_groups
              for p in group["params"]]
    return losses, opt1, params


def names_of(model, params):
    by_id = {id(p): n for n, p in model.named_parameters()}
    return [by_id[id(p)] for p in params]


def run(run):
    t, c, dev = run.traffic, run.config, torch.device(run.device)
    hw = tuple(t["hw"])
    state = inputs.g_state(common.g_shapes(), run.seed, dev)
    batches = inputs.pool(run.seed, "train", t["pool"], t["batch"], hw, dev,
                          cell=t["label_cell"],
                          ignore_share=t["ignore_share"])
    g, opt, step, it = program_steps(run, state, batches)
    losses, opt1, params = first_steps(run, it, step, opt, t["check_steps"])
    names = names_of(g, [p for grp in opt.param_groups for p in grp["params"]])
    for _ in range(t["warmup_steps"]):
        step(*next(it))
    common.sync(dev)
    setup_s = time.time() - run.t0_wall
    out = common.timed(run, it, step, images_per_step=t["batch"])
    memory = common.memory_peak(dev)
    program = {"losses": [[float(x)] for x in losses], "opt1": opt1,
               "params": params}
    del g, opt, step, it
    common.free(dev)

    opt_c = c["optimizer"]
    reference = R.train_steps(
        state, [(b[0], b[1]) for b in batches[:t["check_steps"]]],
        lr=opt_c["lr"], momentum=opt_c["momentum"],
        weight_decay=opt_c["weight_decay"], device=dev)
    if reference["names"] != names:
        raise RuntimeError("the reference's parameters are not the program's")
    numbers = check.training_numbers(
        program, reference, [state[n] for n in names],
        check.sgd_first_grad(opt_c["weight_decay"]), names)
    return result(run, out, setup_s, memory, numbers, "train",
                  flops.train_step(t["batch"], hw),
                  ce_bound(t["batch"], hw, t), t["batch"])


def ce_bound(batch, hw, t):
    """The fused CE's bounds of one step in ms: forward and backward of
    each of the three heads at the pool's valid count."""
    n_valid = batch * inputs.valid_pixels(hw, t["label_cell"],
                                          t["ignore_share"])
    shapes = roofline.head_shapes(batch, hw)
    return roofline.ce_bound_ms(shapes, hw, n_valid)


def result(run, out, setup_s, memory, numbers, kind, flops_per_step,
           ce_bound_ms, images_per_step):
    """The driver's output for ``harness.run_cell``."""
    from .. import trace

    window = out["window"]
    res = {"e2e": {f"{kind}_images_per_s":
                   window["images"] / window["seconds"],
                   "setup_s": setup_s},
           "numbers": numbers, "attempted": window["steps"], "failed": 0,
           "memory_peak_bytes": memory,
           "device_kind": common.device_kind(run.device)}
    if run.trace:
        record = dict(out["record"])
        record.update(kind=kind, chips=1, flops_per_step=flops_per_step,
                      ce_bound_ms_per_step=ce_bound_ms,
                      host={"steps": window["steps"],
                            "seconds": window["seconds"],
                            "fetch_s": out["spans"].get("fetch", 0.0),
                            "step_s": out["spans"].get("step", 0.0),
                            "images_per_step": images_per_step})
        s = trace.summary(record, record.get("host_record"))
        res.update(record=record, busy_s=s["busy_s"], window_s=s["window_s"],
                   breakdown=s["breakdown"])
    return res
