"""Device-facing paged serving engine of the port: the dispatch half of
the serving stack.

The counterpart of ``repro.serving.engine.PagedEngine``: ONE shared
``(n_pages, page_size, KV, hd)`` pool per layer on the device, addressed
through a host-owned ``(n_slots, pages_per_slot)`` int32 block table;
positions are host-tracked int32; page lifetime belongs to the policy
layer's PageAllocator (serving/scheduler.py) — the engine only writes
table rows and runs the steps.  Each decode tick advances every slot by
one token in one step call (sampled and greedy slots alike).

``kernel`` picks how attention reads and writes the pool: "torch" (the
plain scatter + ring gather, JAX's "xla") or "cuda" (the hand-written
paged-attention kernel, JAX's "pallas"), for decode ticks and prefill
blocks alike.  ``device`` defaults to "cuda"; a missing GPU raises.  The
mesh argument of the JAX engine is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import PAGED_KERNELS
from repro_torch.serving.kvcache import (DEFAULT_PAGE_SIZE, init_paged_cache,
                                         paged_attn_layout)
from repro_torch.serving.sampling import SlotSampling
from repro_torch.serving.serve_step import (make_paged_engine_step,
                                            make_paged_prefill_step)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises when it names a GPU that is not
    there (the port never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device}: no CUDA device is available — pass "
            f"device='cpu' to run the plain path on the CPU")
    return device


class PagedEngine:
    """Shared-page-pool decode state: block tables + host-tracked pos."""

    layout = "paged"

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int,
                 capacity: int, page_size: int = DEFAULT_PAGE_SIZE,
                 n_pages: int | None = None, kernel: str = "torch",
                 device="cuda"):
        if kernel not in PAGED_KERNELS:
            raise ValueError(
                f"kernel={kernel!r}: accepted values are {PAGED_KERNELS}")
        self.device = resolve_device(device)
        if params["embed"]["tok"].device.type != self.device.type:
            raise ValueError(
                f"params lie on {params['embed']['tok'].device}, the engine "
                f"on {self.device}")
        self.cfg, self.params = cfg, params
        self.n_slots, self.capacity = n_slots, capacity
        self.page_size = page_size
        self.kernel = kernel
        self.pages_per_slot, logical = paged_attn_layout(
            cfg, capacity, page_size)
        if n_pages is None:  # full provisioning (dense-equivalent)
            n_pages = 1 + n_slots * self.pages_per_slot
        self.n_pages = n_pages
        self.ring_cap = logical
        self.block_table = np.zeros((n_slots, self.pages_per_slot), np.int32)
        self.slot_pos = np.zeros((n_slots,), np.int32)
        self.cache = init_paged_cache(cfg, n_slots, capacity, n_pages,
                                      page_size, dtype=torch.float32,
                                      device=self.device)
        self._decode = make_paged_engine_step(cfg, kernel)
        self._prefill = make_paged_prefill_step(cfg, kernel)
        self._reset_mask = np.zeros((n_slots,), bool)
        # pending copy-on-write page copies, shipped with the next decode
        # tick: slot s copies page _copy_src[s] -> _copy_dst[s] before its
        # token write (dst 0 = no copy queued for that slot)
        self._copy_src = np.zeros((n_slots,), np.int32)
        self._copy_dst = np.zeros((n_slots,), np.int32)
        self.decode_dispatches = 0
        self.prefill_dispatches = 0

    def _dev(self, a) -> torch.Tensor:
        # a copy on the card, a view on the CPU; either way the step is
        # done with it before the host next mutates the array (the step
        # ends in a host read of its outputs), unlike an asynchronous
        # dispatch that may alias the buffer
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # --------------------------------------------------- slot lifecycle

    def mark_reset(self, s: int):
        """Zero slot s's dense lanes in the next tick (a pure-attention
        cache has none; kept for the batcher's decode-prefill path)."""
        self._reset_mask[s] = True

    def admit(self, s: int, pages=None, pos0: int = 0):
        """Point slot s's block-table row at `pages`; pos0 > 0 jump-starts
        behind a refcount-shared prompt prefix."""
        self.block_table[s, :] = 0
        if pages:
            self.block_table[s, :len(pages)] = pages
        self.slot_pos[s] = pos0

    def release(self, s: int):
        """Fall the row back to the null page so the idle lane's writes
        land nowhere live (the allocator reclaims the pages host-side)."""
        self.block_table[s, :] = 0
        self._copy_src[s] = 0
        self._copy_dst[s] = 0

    def fork_slot(self, src: int, dst: int):
        """Fork slot src's sequence into slot dst: block-table row and
        position copied host-side — every page is now shared between the
        two rows (a branch that writes a shared page goes through
        queue_copy first)."""
        self.block_table[dst, :] = self.block_table[src, :]
        self.slot_pos[dst] = self.slot_pos[src]

    def queue_copy(self, s: int, src: int, dst: int):
        """Queue a copy-on-write page copy for slot s's next decode tick:
        pool page dst becomes a copy of page src before slot s's token
        write lands on it."""
        if dst <= 0:
            raise ValueError(f"slot {s}: copy destination {dst} — the null "
                             f"page is never written")
        self._copy_src[s] = src
        self._copy_dst[s] = dst

    def set_page(self, s: int, idx: int, pid: int):
        """Point entry idx of slot s's block-table row at page pid."""
        self.block_table[s, idx] = pid

    def set_pos(self, s: int, pos: int):
        self.slot_pos[s] = pos

    # ---------------------------------------------------------- compute

    def prefill_block(self, s: int, block, off: int, reset: bool,
                      row: SlotSampling):
        """Write a (1, S) prompt block into slot s's pages in one step;
        returns (token, margin, logprob) sampled from its last position."""
        tok, margin, logprob, self.cache = self._prefill(
            self.params, self.cache, s, self._dev(block),
            self._dev(np.array([off], np.int32)),
            self._dev(self.block_table[s:s + 1]), reset, row)
        self.prefill_dispatches += 1
        return int(tok), float(margin), float(logprob)

    def decode(self, toks, active_mask, sampling: SlotSampling):
        """One tick: every slot advances one token in one step call."""
        nxt, margins, logps, self.cache = self._decode(
            self.params, self.cache, self._dev(toks),
            self._dev(self.slot_pos), self._dev(self.block_table),
            self._reset_mask, self._copy_src, self._copy_dst, sampling)
        self.decode_dispatches += 1
        self._reset_mask[:] = False
        self._copy_src[:] = 0
        self._copy_dst[:] = 0
        self.slot_pos[active_mask] += 1  # idle lanes stay pinned
        return (nxt.cpu().numpy(), margins.cpu().numpy(),
                logps.cpu().numpy())

    def cache_nbytes(self) -> int:
        """Decode-state bytes: device pools plus the host block table and
        pos vector."""
        n = sum(t.numel() * t.element_size()
                for t in self.cache["layers"].values())
        return n + self.block_table.nbytes + self.slot_pos.nbytes
