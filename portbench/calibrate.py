"""The readings that each limit of ``limits/<cell>.json`` is set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--fault-seeds a,b,c] [--control-seeds a,b,c] [--seconds 2] \\
        [--out <file.jsonl>]

For each seed of ``--seeds`` a sound run of the cell (a short window),
for each of ``--fault-seeds`` a run with each fault of ``FAULTS``
planted under the timed path, and for each of ``--control-seeds`` the
control: the reference itself in the program's place, one precision
below the configuration's (bf16 -> fp8: ``reference/steps.py::
fp8_round``); for each of ``--witness-seeds`` the program in fp32 with
TF32 off, a second witness of what the gap owes to the precision. One
JSON line a reading, with every number the check works out. Runs on the
cards the cell asks for.
"""

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: the faults read on the chip (``drivers/train.py::faulty``; a step that
#: leaves the state unchanged reads 1 on ``change`` and ``head_change`` by
#: the measure itself)
FAULTS = ("half_batch", "lr_x10")


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def control(run, seed):
    """The control's numbers on ``seed`` (module docstring)."""
    import torch

    from portbench import check, inputs
    from portbench.drivers import common
    from portbench.reference import steps as R

    t, c, dev = run.traffic, run.config, torch.device(run.device)
    hw = tuple(t["hw"])
    state = inputs.g_state(common.g_shapes(), seed, dev)
    n = t["check_steps"]
    batches = inputs.pool(seed, "train", n, t["batch"], hw, dev,
                          cell=t["label_cell"], ignore_share=t["ignore_share"])
    o = c["optimizer"]

    def steps(rounding):
        return R.train_steps(state, batches, lr=o["lr"],
                             momentum=o["momentum"],
                             weight_decay=o["weight_decay"], device=dev,
                             rounding=rounding)
    fp32, low = steps(None), steps(R.fp8_round)
    return check.training_numbers(low, fp32,
                                  [state[k] for k in fp32["names"]],
                                  check.sgd_first_grad(o["weight_decay"]),
                                  fp32["names"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from portbench import harness
    from portbench.run import cache_dirs

    cache_dirs(ROOT)
    import torch

    entry, config, traffic, limits = harness.cell(args.workload, ROOT)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s)", file=sys.stderr)
        return 2
    device = "cuda:0"
    lines = []

    def emit(kind, seed, numbers, **extra):
        line = {"workload": args.workload, "kind": kind, "seed": seed,
                "numbers": numbers, **extra}
        lines.append(line)
        print(json.dumps(line), flush=True)

    def run_of(seed, fault=None):
        return harness.Run(args.workload, config, traffic, limits, seed,
                           args.seconds, False, device, chips, time.time(),
                           fault)

    for fault, seeds in [(None, _seeds(args.seeds))] + [
            (f, _seeds(args.fault_seeds)) for f in FAULTS]:
        for seed in seeds:
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 device, chips, time.time(), ROOT,
                                 fault=fault, keep_numbers=True)
            emit(fault or "sound", seed, r["numbers"], correct=r["correct"],
                 metrics=r["metrics"])
    for seed in _seeds(args.control_seeds):
        emit("control", seed, control(run_of(seed), seed))
    if _seeds(args.witness_seeds):
        # the program in fp32 (TF32 off) against the reference: what is
        # left of the gap is the program's, not its precision's
        from portbench.reference.steps import fp32_math
        with fp32_math():
            for seed in _seeds(args.witness_seeds):
                r = harness.run_cell(args.workload, seed, args.seconds, False,
                                     device, chips, time.time(), ROOT,
                                     overrides={"config": {"dtype": "float32"}},
                                     keep_numbers=True)
                emit("witness_fp32", seed, r["numbers"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
