"""PyTorch + CUDA port of ``dasemanticsegmentationaml_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference every module here is held
against; each module names its JAX counterpart by file and line. The port
runs supervised training (with ``--iter_size`` accumulation),
``--domain_adaptation``, ``--resume`` of either, and the
``--domain_shift`` evaluation of BiSeNet-STDC813 (``cli.py``), on one
device or data-parallel over the ranks of a process group
(``parallel/``), the serving artifacts and their runner
(``utils/export.py``, ``serve.py``), the HPO harness (``hpo/``: a trial
is a DA run of the CLI, the experiment runner sweeps trials with the
Anneal tuner), and two diagnostics (``tools/``: the copy-bandwidth
probe and the 16-bit roll).
Every kernel the JAX package wrote in Pallas is a hand-written CUDA kernel
here (``ops/cuda/``, sources in ``csrc/``), each with its plain PyTorch
version beside it.

Layout mirrors the JAX package: ``models/``, ``ops/`` with ``ops/cuda/``
in place of ``ops/pallas/``, ``data/``, ``train/``, ``utils/``, ``tools/``,
``parallel/``, ``hpo/``, ``cli.py``; CUDA sources live in ``csrc/``. This
package imports no JAX.
"""

__version__ = "0.1.0"
