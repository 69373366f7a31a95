"""Paged attention over a shared KV page pool (CUDA kernel + plain
version)."""
