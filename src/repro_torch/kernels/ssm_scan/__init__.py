"""Chunked gated-linear-attention scan for the no-cache forward of the
Mamba2 and RWKV6 mixers (CUDA kernel + plain version)."""
