"""Hand-written Hopper kernels, each with its plain PyTorch version beside
it (counterpart of the JAX package's ``ops/pallas/``)."""

_PACKAGE = __name__.split(".")[0]
#: the namespace of the port's custom ops (``dseg::upsample_argmax``,
#: ``dseg::upsample_argmax_window``, ``dseg::int8_conv``, and
#: ``parallel/spatial.py``'s ``dseg::halo_exchange`` and
#: ``dseg::spatial_sum``); a second copy of the package imported under
#: another name (``chip_smoke.py --baseline``) registers its ops in a
#: namespace of its own, so that they stay its own kernels
OP_NAMESPACE = ("dseg" if _PACKAGE == "dasemanticsegmentationaml_tpu_torch"
                else f"dseg_{_PACKAGE}")
