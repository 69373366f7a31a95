"""GreedyTL's Gram statistic and candidate scoring (CUDA kernels + plain
versions)."""
