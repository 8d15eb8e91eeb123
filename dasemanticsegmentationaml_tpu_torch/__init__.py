"""PyTorch + CUDA port of ``dasemanticsegmentationaml_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference every module here is held
against; each module names its JAX counterpart by file and line. The port
runs the ``--domain_shift`` evaluation path: a uint8 image is normalised,
run through BiSeNet-STDC813 in eval mode, and the main head's stride-8
logits go through the fused bilinear upsample + argmax kernel
(``ops/cuda/upsample_argmax.py``, source ``csrc/upsample_argmax.cu``) into
the confusion-matrix mIoU. Training, domain adaptation and the other
entry points are still to be ported (ROADMAP.md).

Layout mirrors the JAX package: ``models/``, ``ops/`` with ``ops/cuda/``
in place of ``ops/pallas/``, ``data/``, ``train/evaluate.py``, ``utils/``,
``cli.py``; CUDA sources live in ``csrc/``. This package imports no JAX.
"""

__version__ = "0.1.0"
