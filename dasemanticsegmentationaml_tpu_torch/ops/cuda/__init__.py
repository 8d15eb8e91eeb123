"""Hand-written Hopper kernels, each with its plain PyTorch version beside
it (counterpart of the JAX package's ``ops/pallas/``)."""
