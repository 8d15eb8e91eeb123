"""One benchmark run of one cell of ``BENCHMARK.json`` on the cards here.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints progress, then, as its last lines on
standard error, each number the check compared beside its limit, and as
the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checked``. Exits non-zero, printing no result,
without the cards the cell asks for, without the port's package, or when
JAX or the package the port was made from is loaded once the window has
closed.

The port's kernel builds stay inside the checkout (``build/``: the
port's own ``build/torch_kernels/``, and the extension and Triton caches
set here).
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


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed places inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    # a library that would load JAX by itself keeps from it
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs(ROOT)
    from portbench import harness

    entry = harness.cell(args.workload, ROOT)[0]
    import torch

    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); {have} here",
              file=sys.stderr)
        return 2
    try:
        import dasemanticsegmentationaml_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port's package is not here: {e}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", chips, T0_WALL,
                              ROOT)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checked"].items():
        print(f"checked {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
