"""Blockwise causal flash attention for the no-cache forward (CUDA kernel
+ plain version)."""
