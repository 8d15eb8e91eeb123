"""Rank processes for the port's data-parallel tests on the CPU.

``run_ranks(fn, tmp_path, **kwargs)`` spawns ``world`` processes that join
one gloo process group through a ``file://`` store in ``tmp_path`` (six
test workers never race for a port), each on one torch thread, runs
``fn(rank, world, **kwargs)`` in each and returns their results in rank
order. The group's initialisation and every join carry a timeout, so a
hung rank fails its test instead of holding the run. The children import
torch and the port, never JAX: nothing here imports JAX, and a spawned
child imports only this module and what ``fn`` needs.

The rank functions below run the port's sharded steps and sharded eval
on each rank's rows of a global batch; ``per_replica_reference`` is the
per-replica step done by one process.
"""

import datetime
import multiprocessing
import os
import time
import uuid

import numpy as np
import torch

#: seconds the ranks of one ``run_ranks`` may take
JOIN_TIMEOUT = 300
#: seconds ``init_process_group`` waits for the other ranks
INIT_TIMEOUT = datetime.timedelta(seconds=120)


def _entry(fn, rank, world, init, out, backend, kwargs):
    import torch.distributed as dist

    torch.set_num_threads(1)
    extra = {}
    if backend == "nccl":
        extra["device_id"] = torch.device("cuda", 0)
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=INIT_TIMEOUT, **extra)
    try:
        torch.save(fn(rank, world, **kwargs), out)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, tmp_path, world=2, timeout=JOIN_TIMEOUT, backend="gloo",
              **kwargs):
    """``fn(rank, world, **kwargs)`` in ``world`` ranks of a ``backend``
    group (NCCL: on cuda:0); their results in rank order (module
    docstring)."""
    ctx = multiprocessing.get_context("spawn")
    tag = uuid.uuid4().hex[:8]
    init = f"file://{tmp_path}/store-{tag}"
    outs = [os.path.join(str(tmp_path), f"{fn.__name__}-{tag}-{r}.pt")
            for r in range(world)]
    procs = [ctx.Process(target=_entry, name=f"rank-{r}",
                         args=(fn, r, world, init, outs[r], backend, kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    hung = [p.name for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"{hung} still running after {timeout} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    results = [torch.load(o, weights_only=False) for o in outs]
    for o in outs:
        os.remove(o)
    return results


# ------------------------------------------------------------ rank bodies

def _rows(rank, world, n):
    b = n // world
    return slice(rank * b, (rank + 1) * b)


def _snapshot(rank, *modules):
    """Rank 0: every tensor of each module's state dict, in float64; the
    other ranks: the floating buffers, and each parameter's float64 sum
    (to hold the ranks' parameters equal)."""
    snaps = []
    for m in modules:
        state = {k: v.detach().to("cpu", torch.float64).numpy().copy()
                 for k, v in m.state_dict().items()}
        params = {n for n, _ in m.named_parameters()}
        if rank == 0:
            snaps.append(state)
        else:
            snaps.append({k: (float(v.sum()) if k in params else v)
                          for k, v in state.items()})
    return snaps


def _bisenet(state_path):
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import BiSeNet
    from dasemanticsegmentationaml_tpu_torch.utils.weights import (
        load_reference_state)

    model = BiSeNet(19)
    load_reference_state(model, torch.load(state_path, weights_only=True),
                         strict=True)
    return model.train()


def sync_bn_layer(rank, world, *, x, weight, bias, dy, steps):
    """A ``SyncBatchNorm2d`` (converted from ``nn.BatchNorm2d``) on this
    rank's rows of ``x``: per step the output and the gradients of
    ``sum(y * dy)``; then the running statistics and an eval forward."""
    import torch.nn as nn

    from dasemanticsegmentationaml_tpu_torch.parallel.sync_bn import (
        convert_sync_batchnorm)

    rows = _rows(rank, world, x.shape[0])
    net = nn.Sequential(nn.BatchNorm2d(x.shape[1]))
    with torch.no_grad():
        net[0].weight.copy_(torch.from_numpy(weight))
        net[0].bias.copy_(torch.from_numpy(bias))
    convert_sync_batchnorm(net)
    out = {"steps": []}
    for _ in range(steps):
        xs = torch.from_numpy(x[rows]).requires_grad_()
        net.zero_grad()
        y = net(xs)
        (y * torch.from_numpy(dy[rows])).sum().backward()
        out["steps"].append({"y": y.detach().numpy(),
                             "dx": xs.grad.numpy(),
                             "dweight": net[0].weight.grad.numpy().copy(),
                             "dbias": net[0].bias.grad.numpy().copy()})
    out["running_mean"] = net[0].running_mean.numpy()
    out["running_var"] = net[0].running_var.numpy()
    out["num_batches_tracked"] = int(net[0].num_batches_tracked)
    with torch.no_grad():
        out["eval"] = net.eval()(torch.from_numpy(x[rows])).numpy()
    return out


def ohem_shares(rank, world, *, logits, labels, cases):
    """``sync_ohem_cross_entropy`` on this rank's rows: {case: (the share,
    the logits' gradient)}; ``cases``: {name: (threshold, keep_num)}."""
    from dasemanticsegmentationaml_tpu_torch.parallel.mesh import (
        sync_ohem_cross_entropy)

    rows = _rows(rank, world, logits.shape[0])
    out = {}
    for name, (threshold, keep) in cases.items():
        x = torch.from_numpy(logits[rows]).requires_grad_()
        share = sync_ohem_cross_entropy(x, torch.from_numpy(labels[rows]),
                                        threshold, keep)
        share.backward()
        out[name] = (float(share), x.grad.numpy())
    return out


def ce_float64(logits, labels, out_hw, ignore_index=255):
    """fp64 CE(ignore) of the align_corners upsample (the fused CE takes
    fp32 and bf16 only; tests/test_torch_train.py::_ce_float64)."""
    import torch.nn.functional as F

    up = F.interpolate(logits, out_hw, mode="bilinear", align_corners=True)
    valid = (labels != ignore_index) & (labels >= 0) & (labels < up.shape[1])
    loss = F.cross_entropy(up, torch.where(valid, labels, 0).long(),
                           reduction="none")
    return torch.where(valid, loss, 0.0).sum() / valid.sum().clamp_min(1)


def train_steps(rank, world, *, state_path, x, y, cases, lr, wd,
                fp64=False):
    """One sharded SGD step a case, each from the weights of
    ``state_path``: {case: (the step's loss, snapshot)}.
    ``cases``: {name: (sync_bn, ohem)}; ``fp64``: the model and the step
    in float64, CE through ``ce_float64``."""
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.parallel.mesh import (
        make_sharded_train_step)
    from dasemanticsegmentationaml_tpu_torch.train.optim import (
        make_optimizer)

    rows = _rows(rank, world, x.shape[0])
    dtype = torch.float64 if fp64 else torch.float32
    kw = {"ce": ce_float64} if fp64 else {}
    out = {}
    for name, (sync_bn, ohem) in cases.items():
        model = _bisenet(state_path).to(dtype)
        opt = make_optimizer("sgd", trainable_parameters(model), lr,
                             momentum=0.9, weight_decay=wd)
        step = make_sharded_train_step(model, opt, num_classes=19,
                                       sync_bn=sync_bn, ohem=ohem, **kw)
        loss = step(torch.from_numpy(x[rows]).to(dtype),
                    torch.from_numpy(y[rows]))
        out[name] = (float(loss), _snapshot(rank, model)[0])
    return out


def accumulated_steps(rank, world, *, state_path, batches, lr, wd, k):
    """``len(batches)`` sync-mode mini-steps through a
    ``GradientAccumulator`` over ``k`` (``--iter_size k``): (the losses,
    snapshot)."""
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.parallel.mesh import (
        make_sharded_train_step)
    from dasemanticsegmentationaml_tpu_torch.train.optim import (
        GradientAccumulator, make_optimizer)

    model = _bisenet(state_path)
    opt = make_optimizer("sgd", trainable_parameters(model), lr,
                         momentum=0.9, weight_decay=wd)
    step = make_sharded_train_step(model, opt, num_classes=19,
                                   accumulator=GradientAccumulator(opt, k))
    losses = []
    for x, y in batches:
        rows = _rows(rank, world, x.shape[0])
        losses.append(float(step(torch.from_numpy(x[rows]),
                                 torch.from_numpy(y[rows]))))
    return losses, _snapshot(rank, model)[0]


def da_steps(rank, world, *, g_path, d_paths, x, y, xt, cases, lr_g, lr_d,
             lam, wd):
    """One sharded DA step a case: {case: (metrics, G snapshot, D
    snapshot)}. ``cases``: {name: (sync_bn, step_mode, d_head, D kind)}."""
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.models.discriminator import (
        build_discriminator)
    from dasemanticsegmentationaml_tpu_torch.parallel.mesh import (
        make_sharded_da_step)
    from dasemanticsegmentationaml_tpu_torch.train.optim import (
        make_optimizer)
    from dasemanticsegmentationaml_tpu_torch.utils.weights import (
        load_reference_state)

    rows = _rows(rank, world, x.shape[0])
    out = {}
    for name, (sync_bn, mode, d_head, kind) in cases.items():
        g = _bisenet(g_path)
        d = build_discriminator(19, *kind)
        load_reference_state(d, torch.load(d_paths[kind], weights_only=True),
                             strict=True)
        d.train()
        g_opt = make_optimizer("sgd", trainable_parameters(g), lr_g,
                               momentum=0.9, weight_decay=wd)
        d_opt = make_optimizer("adam", d.parameters(), lr_d,
                               betas=(0.9, 0.99))
        step = make_sharded_da_step(g, d, g_opt, d_opt, num_classes=19,
                                    lambda_adv=lam, d_head=d_head,
                                    sync_bn=sync_bn, step_mode=mode)
        m = step(torch.from_numpy(x[rows]), torch.from_numpy(y[rows]),
                 torch.from_numpy(xt[rows]))
        out[name] = ({k: float(v) for k, v in m.items()},
                     *_snapshot(rank, g, d))
    return out


def card_train_step(rank, world, *, state_path, x, y, sync_bn,
                    counts=False):
    """One fp32 sharded SGD step (TF32 off) on cuda:0, this rank's rows:
    (loss, snapshot), and with ``counts`` whether ``allreduce_counts`` of
    one rank returned its input."""
    from dasemanticsegmentationaml_tpu_torch.cli import fp32_math
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.parallel.mesh import (
        make_sharded_train_step)
    from dasemanticsegmentationaml_tpu_torch.train.optim import (
        make_optimizer)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rows = _rows(rank, world, x.shape[0])
    model = _bisenet(state_path).to(device)
    opt = make_optimizer("sgd", trainable_parameters(model), 0.01,
                         momentum=0.9, weight_decay=1e-4)
    step = make_sharded_train_step(model, opt, num_classes=19,
                                   sync_bn=sync_bn)
    with fp32_math():
        loss = step(torch.from_numpy(x[rows]).to(device),
                    torch.from_numpy(y[rows]).to(device))
    out = (float(loss), _snapshot(rank, model)[0])
    if counts:
        from dasemanticsegmentationaml_tpu_torch.parallel.distributed import (
            allreduce_counts)

        hist = torch.arange(361, dtype=torch.int64, device=device) + 2**33
        h, c, t = allreduce_counts(hist.reshape(19, 19),
                                   torch.tensor(2**35, device=device),
                                   2**36 + 1)
        out += (bool(torch.equal(h.reshape(-1), hist)) and int(c) == 2**35
                and t == 2**36 + 1,)
    return out


def counts_above_int32(rank, world):
    """``allreduce_counts`` of counts past 2^31 on every rank."""
    from dasemanticsegmentationaml_tpu_torch.parallel.distributed import (
        allreduce_counts)

    hist = torch.full((19, 19), 2**31 + 7, dtype=torch.int64)
    hist[rank, rank] = 2**40 + rank
    correct = torch.tensor(2**33 + 3 * rank, dtype=torch.int64)
    h, c, t = allreduce_counts(hist, correct, 2**35 + rank)
    return h.numpy(), int(c), t


def sharded_eval(rank, world, *, state_path, images, labels, perturb):
    """This rank's strided shard of the val set through the port's eval
    with ``cross_process_sum``: the summed counts and (precision, mIoU).
    ``perturb``: ranks above 0 first move their BN statistics, and
    evaluate with rank 0's (``rank0_buffers``), which must come back."""
    from dasemanticsegmentationaml_tpu_torch.data.datasets import Subset
    from dasemanticsegmentationaml_tpu_torch.data.pipeline import (
        Loader, prepare_batch)
    from dasemanticsegmentationaml_tpu_torch.parallel.distributed import (
        allreduce_counts)
    from dasemanticsegmentationaml_tpu_torch.parallel.mesh import (
        rank0_buffers, untile_state)
    from dasemanticsegmentationaml_tpu_torch.train.evaluate import (
        eval_counts, evaluate)

    model = _bisenet(state_path).eval()
    own = None
    if perturb and rank > 0:
        with torch.no_grad():
            for name, buf in model.named_buffers():
                if name.endswith("running_var"):
                    buf.mul_(3.0)
        own = {k: v.clone() for k, v in model.state_dict().items()}
    ds = Subset(_Pairs(images, labels), list(range(rank, len(images), world)))
    loader = Loader(ds, 1, num_workers=1)
    cpu = torch.device("cpu")

    def prepare(batch):
        return prepare_batch(*batch, device=cpu)

    with rank0_buffers(model):
        hist, correct, total = eval_counts(model, loader, 19,
                                           prepare=prepare, device=cpu)
        hist, correct, total = allreduce_counts(hist, correct, total)
        metrics = evaluate(model, loader, 19, prepare=prepare, device=cpu,
                           cross_process_sum=True, print_results=False)
    if own is not None:
        for k, v in model.state_dict().items():
            assert torch.equal(v, own[k]), k
    untiled = {k: v.numpy() for k, v in untile_state(model).items()}
    return hist.numpy(), int(correct), total, metrics, untiled


class _Pairs:
    """(image HWC uint8, label HW uint8) pairs held in memory."""

    def __init__(self, images, labels):
        self.images, self.labels = images, labels

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.labels[i]


# ------------------------------------------------ one-process references

def per_replica_reference(state_path, x, y, lr, wd, world=2,
                          dtype=torch.float32, ohem=None, ce=None,
                          device="cpu"):
    """The per-replica step in one process: ``world`` copies of the model,
    each through its rows with its own BN statistics, the gradients
    averaged into copy 0 and one SGD step. Returns (mean loss, copy 0's
    snapshot, each copy's floating buffers)."""
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.train.optim import (
        make_optimizer)
    from dasemanticsegmentationaml_tpu_torch.train.supervised import (
        make_supervised_loss)

    models = [_bisenet(state_path).to(device, dtype) for _ in range(world)]
    opt = make_optimizer("sgd", trainable_parameters(models[0]), lr,
                         momentum=0.9, weight_decay=wd)
    kw = {} if ce is None else {"ce": ce}
    losses = []
    for r, m in enumerate(models):
        rows = _rows(r, world, x.shape[0])
        loss = make_supervised_loss(m, ohem=ohem, **kw)(
            torch.from_numpy(x[rows]).to(device, dtype),
            torch.from_numpy(y[rows]).to(device))
        loss.backward()
        losses.append(float(loss))
    params = [trainable_parameters(m) for m in models]
    for group in zip(*params):
        if group[0].grad is not None:
            group[0].grad = sum(p.grad for p in group) / world
    opt.step()
    buffers = [{k: v.detach().to("cpu", torch.float64).numpy().copy()
                for k, v in m.named_buffers() if v.is_floating_point()}
               for m in models]
    return float(np.mean(losses)), _snapshot(0, models[0])[0], buffers


# ------------------------------------------------- the height-sharded mesh

#: name -> (kind, its arguments, input shape): the banded ops of
#: ``parallel/spatial.py``, each on a small float64 input
SPATIAL_OPS = {
    "conv3x3_s1_p1": ("conv", (4, 5, 3, 1, 1, 1), (2, 4, 24, 6)),
    "conv3x3_s2_p1": ("conv", (4, 5, 3, 2, 1, 1), (2, 4, 24, 6)),
    "conv1x1": ("conv", (4, 5, 1, 1, 0, 1), (2, 4, 24, 6)),
    "depthwise3x3_s2_p1": ("conv", (4, 4, 3, 2, 1, 4), (2, 4, 24, 6)),
    "conv4x4_s2_p1": ("conv", (4, 5, 4, 2, 1, 1), (2, 4, 24, 6)),
    "depthwise4x4_s2_p1": ("conv", (4, 4, 4, 2, 1, 4), (2, 4, 24, 6)),
    "pointwise1x1_p1": ("conv", (4, 5, 1, 1, 1, 1), (2, 4, 24, 6)),
    "avgpool3_s2_p1": ("pool", None, (2, 4, 24, 6)),
    "global_mean": ("mean", None, (2, 4, 24, 6)),
    "nearest_x2": ("nearest", None, (2, 4, 12, 6)),
    "resize_align_corners": ("resize", (48, 9), (2, 4, 6, 5)),
    "dw_discriminator": ("d", (False,), (1, 3, 96, 32)),
    "dwbn_discriminator_eval": ("d", (True,), (1, 3, 96, 32)),
    "fc_discriminator": ("fc", None, (1, 3, 96, 32)),
}


def spatial_op(name):
    """The module of ``SPATIAL_OPS[name]`` in float64, its parameters
    drawn from a fixed seed (BN layers in eval mode, with drawn
    statistics), or None for the parameterless ops."""
    import torch.nn as nn

    from dasemanticsegmentationaml_tpu_torch.models.discriminator import (
        DepthWiseSepBNFCDiscriminator, DepthWiseSepFCDiscriminator,
        FCDiscriminator)

    kind, args, _ = SPATIAL_OPS[name]
    if kind == "conv":
        c_in, c_out, k, s, p, groups = args
        module = nn.Conv2d(c_in, c_out, k, s, p, groups=groups)
    elif kind == "pool":
        return nn.AvgPool2d(3, 2, 1)
    elif kind == "d":
        module = (DepthWiseSepBNFCDiscriminator(3) if args[0]
                  else DepthWiseSepFCDiscriminator(3))
    elif kind == "fc":
        module = FCDiscriminator(3)
    else:
        return None
    rng = np.random.default_rng(7)
    module = module.double()
    with torch.no_grad():
        for t in module.parameters():
            t.copy_(torch.from_numpy(0.3 * rng.standard_normal(t.shape)))
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.add_(1.0)
                m.running_mean.copy_(torch.from_numpy(
                    0.1 * rng.standard_normal(m.running_mean.shape)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, m.running_var.shape)))
    return module.eval()


def _seed_of(text):
    import zlib

    return zlib.crc32(text.encode())


def spatial_input(name):
    """The op's float64 input and the output cotangent's generator."""
    shape = SPATIAL_OPS[name][2]
    rng = np.random.default_rng(_seed_of(name))
    return rng.standard_normal(shape)


def spatial_full(name, op, x):
    """The unsharded op on the whole ``x``."""
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import mean_hw
    from dasemanticsegmentationaml_tpu_torch.ops.resize import (
        resize_bilinear_align_corners, upsample_nearest)

    kind, args, _ = SPATIAL_OPS[name]
    if kind == "mean":
        return mean_hw(x)
    if kind == "nearest":
        return upsample_nearest(x, (2 * x.shape[2], 2 * x.shape[3]))
    if kind == "resize":
        return resize_bilinear_align_corners(x, args)
    return op(x)


def spatial_cotangent(name, shape):
    rng = np.random.default_rng(_seed_of(name + "dy"))
    return rng.standard_normal(shape)


def banded_ops(rank, world, *, names):
    """Each op of ``names`` on this rank's band of its input (a 1 x world
    mesh), forward and the gradient of sum(y * dy) over this rank's band
    of dy: {name: (y band, its global rows, dx band, the parameters'
    gradients)}. The global mean's output is every rank's: only rank 0
    adds its term."""
    from dasemanticsegmentationaml_tpu_torch.parallel.spatial import (
        Rows, create_mesh_spatial, keep_band, layer_rows)

    torch.set_default_dtype(torch.float64)
    mesh = create_mesh_spatial(1, world)
    out = {}
    for name in names:
        kind, args, _ = SPATIAL_OPS[name]
        op = spatial_op(name)
        x_full = torch.from_numpy(spatial_input(name))
        xs = keep_band(x_full, rank, world).clone().requires_grad_()
        rows = mesh.even_rows(xs)
        with mesh.banded():
            if kind == "conv":
                y, rows = mesh.conv_band(op, xs, rows)
            elif kind == "pool":
                y = mesh.pool_band(op, xs)
                rows = layer_rows(rows, (rows.n - 1) // 2 + 1, 3, 2, 1)
            elif kind == "mean":
                y = mesh.mean_hw(xs)
                rows = Rows((0, 1) + (1,) * (world - 1))
            elif kind == "nearest":
                y = mesh.upsample_nearest(xs, (2 * xs.shape[2],
                                               2 * xs.shape[3]))
                rows = mesh.even_rows(y)
            elif kind == "resize":
                y = mesh.resize_band(xs, (args[0] // world, args[1]))
                rows = mesh.even_rows(y)
            else:
                y, rows = mesh.discriminator(op, xs)
        with torch.no_grad():
            full_shape = spatial_full(name, op, x_full).shape
        dy = torch.from_numpy(spatial_cotangent(name, full_shape))
        a, b = rows.band(rank)
        if kind == "mean" and rank > 0:
            dy = torch.zeros_like(dy)
        (y * dy[:, :, a:b]).sum().backward()
        grads = ({} if op is None else
                 {k: p.grad.numpy().copy() for k, p in op.named_parameters()})
        out[name] = (y.detach().numpy(), (a, b), xs.grad.numpy(), grads)
    return out


def spatial_steps(rank, world, *, spatial, state_path, d_paths, x, y, xt,
                  cases, forward=False, fp64=False):
    """On a (world / spatial) x ``spatial`` mesh, this rank's band of its
    data shard of the global batch: ``forward``: BiSeNet's eval forward
    (the main head upsampled, banded) and the fused eval prediction; then
    one step a case from the weights of ``state_path`` (and
    ``d_paths[kind]``): {case: (metrics or loss, G snapshot, D
    snapshot)}. ``cases``: {name: None (the sync train step) or (D kind,
    step_mode, d_head) (the DA step)}."""
    from dasemanticsegmentationaml_tpu_torch.models.bisenet import (
        trainable_parameters)
    from dasemanticsegmentationaml_tpu_torch.models.discriminator import (
        build_discriminator)
    from dasemanticsegmentationaml_tpu_torch.parallel.mesh import (
        make_sharded_da_step, make_sharded_train_step)
    from dasemanticsegmentationaml_tpu_torch.parallel.spatial import (
        create_mesh_spatial)
    from dasemanticsegmentationaml_tpu_torch.train.evaluate import predict
    from dasemanticsegmentationaml_tpu_torch.train.optim import (
        make_optimizer)
    from dasemanticsegmentationaml_tpu_torch.utils.weights import (
        load_reference_state)

    from dasemanticsegmentationaml_tpu_torch.ops.cuda.fused_ce import (
        cross_entropy_upsampled_reference)

    mesh = create_mesh_spatial(world // spatial, spatial)
    dtype = torch.float64 if fp64 else torch.float32
    xs, ys, xts = mesh.shard(torch.from_numpy(x).to(dtype),
                             torch.from_numpy(y), torch.from_numpy(xt).to(dtype))
    kw = {"ce": cross_entropy_upsampled_reference} if fp64 else {}
    out = {}
    if forward:
        model = mesh.convert(_bisenet(state_path).eval())
        with torch.no_grad(), mesh.banded():
            out["forward"] = model(xs)[0].numpy()
        out["predict"] = predict(model, xs, True, spatial=mesh).numpy()
    for name, case in cases.items():
        g = _bisenet(state_path).to(dtype)
        if case is None:
            opt = make_optimizer("sgd", trainable_parameters(g), 0.01,
                                 momentum=0.9, weight_decay=1e-4)
            step = make_sharded_train_step(g, opt, num_classes=19,
                                           spatial=mesh, **kw)
            out[name] = (float(step(xs, ys)), *_snapshot(rank, g))
            continue
        kind, mode, d_head = case
        d = build_discriminator(19, *kind)
        load_reference_state(d, torch.load(d_paths[kind], weights_only=True),
                             strict=True)
        d = d.to(dtype).train()
        g_opt = make_optimizer("sgd", trainable_parameters(g), 0.01,
                               momentum=0.9, weight_decay=5e-4)
        d_opt = make_optimizer("adam", d.parameters(), 1e-3,
                               betas=(0.9, 0.99))
        step = make_sharded_da_step(g, d, g_opt, d_opt, num_classes=19,
                                    lambda_adv=1e-3, d_head=d_head,
                                    step_mode=mode, spatial=mesh, **kw)
        m = step(xs, ys, xts)
        out[name] = ({k: float(v) for k, v in m.items()},
                     *_snapshot(rank, g, d))
    return out


def ohem_bands(rank, world, *, spatial, logits, labels, cases):
    """``sync_ohem_cross_entropy`` on this rank's band of its data shard
    of a (world / spatial) x ``spatial`` mesh, the losses gathered in the
    global batch's order: {case: (the share, the band's gradient)}."""
    from dasemanticsegmentationaml_tpu_torch.parallel.mesh import (
        sync_ohem_cross_entropy)
    from dasemanticsegmentationaml_tpu_torch.parallel.spatial import (
        create_mesh_spatial)

    mesh = create_mesh_spatial(world // spatial, spatial)
    xs, ys = mesh.shard(torch.from_numpy(logits), torch.from_numpy(labels))
    out = {}
    for name, (threshold, keep) in cases.items():
        x = xs.clone().requires_grad_()
        share = sync_ohem_cross_entropy(x, ys, threshold, keep,
                                        layout=(mesh.data_size, spatial))
        share.backward()
        out[name] = (float(share), x.grad.numpy())
    return out


def int8_bands(rank, world, *, model, inputs):
    """Each int8 block of ``model`` (quantized, unconverted) on this
    rank's band of its whole input, after ``SpatialMesh.convert``: {name:
    the band's output}. ``inputs``: {name: the block's whole input}, a
    name with a ``#`` suffix the block before it."""
    from dasemanticsegmentationaml_tpu_torch.parallel.spatial import (
        create_mesh_spatial, keep_band)

    mesh = create_mesh_spatial(1, world)
    mesh.convert(model)
    blocks = dict(model.named_modules())
    out = {}
    with torch.inference_mode(), mesh.banded():
        for name, x in inputs.items():
            # the context path's (B, C, 1, 1) mean is every rank's whole
            band = x if x.shape[2] == 1 else keep_band(x, rank, world)
            out[name] = blocks[name.split("#")[0]](band.contiguous())
    return out


def spatial_programs(rank, world, *, path, frames):
    """This rank's program of the spatial artifact at ``path`` on its band
    of each uint8 NHWC batch of the list ``frames``, the group registered
    as the serving mesh: [(the band's labels, the exchanges the call
    made)]."""
    from dasemanticsegmentationaml_tpu_torch.parallel import spatial
    from dasemanticsegmentationaml_tpu_torch.utils import export as ex

    mesh = spatial.SpatialMesh(1, world)
    spatial.serve_on(mesh)
    program = ex.read_exported_spatial(path, rank).program.module()
    out = []
    for batch in frames:
        band = batch.shape[1] // world
        before = mesh.exchanges
        with torch.inference_mode():
            labels = program(
                batch[:, rank * band:(rank + 1) * band].contiguous())
        out.append((labels, mesh.exchanges - before))
    spatial.serve_on(None)
    return out


def spatial_predict(rank, world, *, model, images, use_fused_kernel=True):
    """``predict`` of the (quantized) ``model`` on this rank's band of the
    normalised NCHW ``images``, the model converted to a 1 x ``world``
    mesh: the band's labels."""
    from dasemanticsegmentationaml_tpu_torch.parallel.spatial import (
        create_mesh_spatial, keep_band)
    from dasemanticsegmentationaml_tpu_torch.train.evaluate import predict

    mesh = create_mesh_spatial(1, world)
    mesh.convert(model)
    with torch.inference_mode():
        return predict(model, keep_band(images, rank, world).contiguous(),
                       use_fused_kernel, spatial=mesh)
