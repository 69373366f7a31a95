"""Plain PyTorch version of the flash-attention kernel — the port's
counterpart of ``repro.kernels.flash_attention.ref.reference_attention``.

It takes the model layout, q (B, S, H, hd) and k/v (B, S, KV, hd), and
reads query head h's keys from KV head h // g (g = H / KV) by grouping the
query heads, with no expanded copy of K/V.  The softmax is fp32 over the
whole masked (S, S) logit matrix, with all three mask terms (causal,
sliding window, chunked-local); fully masked rows give zeros.  ``ops.py``
runs it for tensors on the CPU, and chip_smoke.py holds the CUDA kernel
against it on the card.
"""
from __future__ import annotations

import torch


def attention_mask(S: int, device, *, causal=True, window=0, chunk=0):
    """Boolean (S, S) mask [query, key] of the kernel's three terms."""
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(S, device=device)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > (qp - window)
    if chunk:
        mask &= (kp // chunk) == (qp // chunk)
    return mask


def reference_attention(q, k, v, *, causal=True, window=0, chunk=0):
    """q: (B, S, H, hd), k/v: (B, S, KV, hd) with H = g*KV.  Returns
    (B, S, H, hd) in v's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    scale = 1.0 / (hd ** 0.5)
    qh = q.float().reshape(B, S, KV, g, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qh, k.float()) * scale
    mask = attention_mask(S, q.device, causal=causal, window=window,
                          chunk=chunk)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return out.reshape(B, S, H, hd).to(v.dtype)
