"""Paged decode state of the port: ONE shared
``(n_pages, page_size, KV, hd)`` pool per layer, addressed through
per-slot block tables of page ids (vLLM-style).

The counterpart of the paged half of ``repro.serving.kvcache``
(``paged_attn_layout`` .. ``reset_paged_sub``), for pure-attention archs.
Page 0 is reserved as the null page: idle lanes and unallocated
block-table entries point at it, so their writes never land on a live
page.  Block tables and positions are host-owned (numpy int32) and passed
into every dispatch; pool pages are never zeroed — the attention mask
only admits ring positions the slot (or a live prefix sharer) wrote.

The JAX functions returned new trees; these update the pools IN PLACE
and return them, so a caller may keep using its own reference.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import check_dense, torch_dtype

DEFAULT_PAGE_SIZE = 16


def attn_ring_len(cfg: ModelConfig, capacity: int) -> int:
    """The dense ring length of one slot: capacity, window-capped."""
    return min(capacity, cfg.sliding_window) if cfg.sliding_window \
        else capacity


def paged_attn_layout(cfg: ModelConfig, capacity: int,
                      page_size: int = DEFAULT_PAGE_SIZE):
    """(pages_per_slot, logical_ring) of the paged layout: the dense ring
    cap (capacity, window-capped) rounded up to whole pages."""
    pages = -(-attn_ring_len(cfg, capacity) // page_size)
    return pages, pages * page_size


def _pool_dtype(cfg: ModelConfig, dtype):
    if dtype is None:
        dtype = torch_dtype(cfg.dtype)
    return torch_dtype(cfg.kv_cache_dtype) if cfg.kv_cache_dtype else dtype


def init_paged_cache(cfg: ModelConfig, n_slots: int, capacity: int,
                     n_pages: int, page_size: int = DEFAULT_PAGE_SIZE,
                     dtype=None, device="cuda"):
    """Paged decode state: {"layers": {"k", "v"}} zero pools of shape
    (L, n_pages, page_size, KV, hd).  No "pos" and no block table live in
    this tree — both are host-owned and passed per dispatch."""
    check_dense(cfg)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    kv_dtype = _pool_dtype(cfg, dtype)
    return {"layers": {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
                       "v": torch.zeros(shape, dtype=kv_dtype, device=device)}}


def paged_cache_bytes(cfg: ModelConfig, n_slots: int, capacity: int,
                      n_pages: int, page_size: int = DEFAULT_PAGE_SIZE,
                      dtype=None) -> int:
    """Device bytes of the paged layout, block table + pos vector included
    (computed from shapes; nothing is allocated)."""
    check_dense(cfg)
    elem = torch.empty((), dtype=_pool_dtype(cfg, dtype)).element_size()
    pool = 2 * cfg.n_layers * n_pages * page_size * cfg.n_kv_heads \
        * cfg.head_dim * elem
    pages_per_slot, _ = paged_attn_layout(cfg, capacity, page_size)
    return pool + n_slots * pages_per_slot * 4 + n_slots * 4


def paged_slot_slice(cfg: ModelConfig, cache, slot):
    """Batch-1 view of slot `slot`: the pools pass whole (the block table,
    not the slice, scopes a slot's pool accesses; a pure-attention cache
    has no per-slot lanes)."""
    return cache


def paged_slot_update(cfg: ModelConfig, cache, slot, sub):
    """Write a batch-1 `sub` back: the pools were updated in place, so
    `sub`'s pools ARE the cache's; returns the cache."""
    return cache


def reset_paged_slots(cfg: ModelConfig, cache, mask):
    """Zero the per-slot dense lanes of every slot where mask is True.  A
    pure-attention cache has none: pool pages are reclaimed by the
    allocator and their stale contents masked by position validity."""
    return cache


def reset_paged_sub(cfg: ModelConfig, sub, reset):
    """Zero a batch-1 sub-cache's dense lanes where `reset` (none for a
    pure-attention cache)."""
    return sub


def cow_copy_pages(cfg: ModelConfig, cache, copy_src, copy_dst):
    """Copy-on-write page copies, before the forward that writes them:
    for every pair (copy_src[i], copy_dst[i]) with dst > 0, page dst of
    every layer's pools becomes a copy of page src.  Rows with dst == 0
    are no-ops.  copy_src / copy_dst: (n_slots,) int32 numpy page ids,
    one potential copy per slot per tick.  In place; returns the cache."""
    pairs = [(int(s), int(d)) for s, d in zip(copy_src, copy_dst) if d > 0]
    if not pairs:
        return cache
    for pool in (cache["layers"]["k"], cache["layers"]["v"]):
        dev = pool.device
        src = torch.tensor([s for s, _ in pairs], device=dev)
        dst = torch.tensor([d for _, d in pairs], device=dev)
        pool[:, dst] = pool[:, src]
    return cache
