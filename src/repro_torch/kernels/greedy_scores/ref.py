"""Plain PyTorch versions of the GreedyTL kernels (the port's
``repro.kernels.greedy_scores.ref``), batched over a leading axis.

The CPU runs them through ``ops.py``; ``kernel="torch"`` calls them on any
device; ``chip_smoke.py`` and the card's tests hold the CUDA kernels
against them."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def reference_gram(Z):
    """G = Z^T Z per batch row.  Z: (B, m, n) -> (B, n, n) float32."""
    Z = Z.float()
    return Z.mT @ Z


def reference_scores(corr, diag, selected_mask, lam: float):
    """score_j = corr_j^2 / (diag_j + lam), NEG_INF on selected columns, and
    each row's argmax (the lowest index on a tie).

    corr/diag: (B, n) float; selected_mask: (B, n) bool.  Returns
    (scores (B, n) float32, idx (B,) int32)."""
    s = corr.float() ** 2 / (diag.float() + lam)
    s = torch.where(selected_mask, NEG_INF, s)
    return s, s.argmax(-1).to(torch.int32)
