"""Plain PyTorch versions of the paged-attention kernel — the port's
counterparts of ``repro.kernels.paged_attention.ref``.

They gather each slot's logical ring out of the shared page pool through
its block-table row, mask by position validity (stale and null-page
entries hold k_pos < 0 or fall outside the causal window) and take an
fp32 softmax.  ``ops.py`` runs them for tensors on the CPU, and
chip_smoke.py holds the CUDA kernel against them on the card.

``reference_paged_update`` writes the S new rows into the pools IN PLACE
(the JAX oracle returned new pools), as the kernel does.
"""
from __future__ import annotations

import torch


def ring_positions(last, T: int):
    """Absolute position held by ring slot i after the newest write:
    the largest value congruent to i (mod T) that is <= last — negative
    (invalid) for ring entries no sequence has reached yet.  (B, T)."""
    idx = torch.arange(T, device=last.device)
    return last[:, None] - ((last[:, None] - idx[None, :]) % T)


def _gather_ring(pool, block_table):
    psz = pool.shape[1]
    T = block_table.shape[1] * psz
    ring = torch.arange(T, device=pool.device)
    g_idx = block_table[:, ring // psz] * psz + ring % psz       # (B, T)
    flat = pool.reshape((-1,) + tuple(pool.shape[2:]))
    return flat[g_idx].float()                                   # (B, T, KV, hd)


def reference_paged_attention(q, k_pool, v_pool, block_table, last_pos, *,
                              window: int = 0):
    """q: (B, H, hd) — one query token per slot, at position last_pos[b];
    its K/V already in the pools.  Returns (B, H, hd) in q's dtype."""
    out = reference_paged_attention_block(q[:, None], k_pool, v_pool,
                                          block_table, last_pos,
                                          window=window)
    return out[:, 0]


def reference_paged_attention_block(q, k_pool, v_pool, block_table,
                                    last_pos, *, window: int = 0,
                                    q_positions=None):
    """q: (B, S, H, hd) — an S-token query block per slot; row s is the
    query at position q_positions[b, s] (default: the contiguous block
    last_pos - S + 1 .. last_pos).  K/V for every row must already be in
    the pool.  Returns (B, S, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    KV = k_pool.shape[2]
    g = H // KV
    T = block_table.shape[1] * k_pool.shape[1]
    ck = _gather_ring(k_pool, block_table)
    cv = _gather_ring(v_pool, block_table)
    if q_positions is None:
        q_positions = last_pos[:, None] - (S - 1) + \
            torch.arange(S, device=q.device)[None, :]
    k_pos = ring_positions(last_pos, T)[:, None, :]              # (B, 1, T)
    qp = q_positions[..., None]                                  # (B, S, 1)
    valid = (k_pos >= 0) & (k_pos <= qp)                         # (B, S, T)
    if window:
        valid &= k_pos > (qp - window)
    qh = q.reshape(B, S, KV, g, hd).float()
    scale = 1.0 / float(hd) ** 0.5
    s = torch.einsum("bskgh,btkh->bskgt", qh, ck) * scale
    s = s.masked_fill(~valid[:, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully masked rows (idle slots)
    out = torch.einsum("bskgt,btkh->bskgh", p, cv)
    return out.reshape(B, S, H, hd).to(q.dtype)


def reference_paged_update(q, k_new, v_new, k_pool, v_pool, block_table,
                           last_pos, *, window: int = 0, q_positions=None):
    """Scatter-then-attend: the S new K/V rows (k_new/v_new
    (B, S, KV, hd)) land at ring slots (last_pos - S + 1 .. last_pos) % T
    through the block table, cast to the pool dtype, written in place;
    then block attention reads them back.  Returns (out, k_pool, v_pool)
    with the pools the caller passed."""
    B, S = q.shape[:2]
    psz = k_pool.shape[1]
    T = block_table.shape[1] * psz
    abs_pos = last_pos[:, None] - (S - 1) + \
        torch.arange(S, device=q.device)[None, :]
    slots = abs_pos % T
    b_idx = torch.arange(B, device=q.device)[:, None]
    w_idx = (block_table[b_idx, slots // psz] * psz
             + slots % psz).reshape(-1).long()
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        flat = pool.view((-1,) + tuple(pool.shape[2:]))
        flat.index_copy_(0, w_idx, new.reshape((-1,) + tuple(new.shape[2:]))
                         .to(pool.dtype))
    out = reference_paged_attention_block(
        q, k_pool, v_pool, block_table, last_pos, window=window,
        q_positions=q_positions)
    return out, k_pool, v_pool
