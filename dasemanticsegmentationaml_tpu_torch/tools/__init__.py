"""Diagnostics of the port, counterparts of the JAX package's ``tools/``
scripts that reach ``pl.pallas_call``: ``probe_copy`` (device-memory copy
bandwidth, for ``tools/probe_pallas_dma.py`` and ``tools/probe_dma_manual.py``)
and ``roll_repro`` (the 16-bit roll, for ``tools/mosaic_roll_repro.py``).
Each runs with ``python -m dasemanticsegmentationaml_tpu_torch.tools.<name>``
on ``cuda:0``, or with ``--device cpu`` through the plain versions."""
