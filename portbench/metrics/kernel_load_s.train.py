"""``kernel_load_s.train``: the seconds a train cell's run spent building
and loading the port's CUDA libraries, the port's own counter
``kernels.load_s`` (``utils/logging_util.py::snapshot``; nothing loads
after set-up, so the run's end reads what set-up spent). Prints the
``nvcc`` builds it counted, by source, on standard error. None where the
port keeps no such counter."""

import importlib
import sys

PORT_COUNTERS = "dasemanticsegmentationaml_tpu_torch.utils.logging_util"


def read(record):
    if record.get("kind") != "train":
        return None
    snapshot = getattr(importlib.import_module(PORT_COUNTERS), "snapshot",
                       None)
    if snapshot is None:
        return None
    counts = snapshot()
    builds = {k[len("kernels.builds."):]: v for k, v in counts.items()
              if k.startswith("kernels.builds.")}
    print(f"kernels: {counts['kernels.load_s']!r} s built and loaded, "
          f"nvcc builds {builds}", file=sys.stderr, flush=True)
    return counts["kernels.load_s"]
