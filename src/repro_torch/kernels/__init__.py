"""Hand-written Hopper kernels of the port, one package per TPU kernel
they replace, each with its plain PyTorch version beside it."""
