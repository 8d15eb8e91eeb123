"""Data parallelism over the ranks of a process group (the port of
``dasemanticsegmentationaml_tpu/parallel/``; the reference's
``nn.DataParallel``, train.py:497): ``distributed.py`` joins the group and
holds its collectives, ``sync_bn.py`` normalises over the global batch,
``mesh.py`` holds the sharded train and DA steps, ``spatial.py`` the
height-sharded mesh (``--spatial_devices``: bands of image rows and their
halo exchanges)."""
