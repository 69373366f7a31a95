"""Serving steps of the port: the no-cache prefill (full-sequence forward,
logits only), the paged engine's fused decode tick and its chunked-prefill
block — the counterparts of ``repro.serving.serve_step.make_prefill_step``,
``make_paged_engine_step`` and ``make_paged_prefill_step``.

Each step runs, in this order: reset -> copy-on-write page copies ->
forward -> scores -> argmax + margin -> logprob.  The copy precedes the
forward, so a write into a just-forked page always lands on the branch's
private copy, whichever kernel writes the pool.  The pools are updated
in place; the steps return the cache tree they were given.
"""
from __future__ import annotations

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kvcache import (cow_copy_pages, paged_slot_slice,
                                         paged_slot_update, reset_paged_slots,
                                         reset_paged_sub)
from repro_torch.serving.sampling import (argmax_with_margin, batched_scores,
                                          row_scores, token_logprob)


def make_prefill_step(cfg: ModelConfig, kernel: str = "torch"):
    """Full-sequence forward (the inference-prefill shape): logits only.

    step(params, tokens) -> logits (B, S, V); tokens: (B, S) int tensor.
    kernel: "torch" (the plain attention and scan) or "cuda" (the
    flash-attention and scan kernels), the counterpart of the
    reference's ``use_pallas``."""

    def step(params, tokens):
        return T.forward(params, cfg, tokens, kernel=kernel).logits

    return step


def make_paged_engine_step(cfg: ModelConfig, kernel: str = "torch"):
    """Fused slot-batched decode against the shared page pool.

    step(params, cache, tokens, pos, block_table, reset_mask, copy_src,
         copy_dst, sampling) -> (next_tok, margin, logprob, cache)

    tokens: (n_slots, 1) int tensor; pos: (n_slots,) int32 tensor of
    host-tracked positions; block_table: (n_slots, P) int32 tensor;
    reset_mask, copy_src, copy_dst: host numpy arrays; sampling: a
    SlotSampling of host arrays.  kernel: "torch" (plain scatter + ring
    gather) or "cuda" (the paged-attention kernel)."""

    def step(params, cache, tokens, pos, block_table, reset_mask,
             copy_src, copy_dst, sampling):
        cache = reset_paged_slots(cfg, cache, reset_mask)
        cache = cow_copy_pages(cfg, cache, copy_src, copy_dst)
        full = dict(cache, pos=pos, block_table=block_table)
        out = T.forward(params, cfg, tokens, cache=full, paged_kernel=kernel)
        logits = out.logits[:, -1]
        scores = batched_scores(logits, sampling)
        next_tok, margin = argmax_with_margin(scores)
        logprob = token_logprob(logits, next_tok)
        return next_tok, margin, logprob, cache

    return step


def make_paged_prefill_step(cfg: ModelConfig, kernel: str = "torch"):
    """Chunked prefill of one slot against the shared page pool.

    step(params, cache, slot, tokens, pos0, bt_row, reset, row)
        -> (next_tok, margin, logprob, cache)

    tokens: (1, S) int tensor, written at positions pos0 .. pos0+S-1
    through `bt_row` ((1, P) int32 tensor) into the pool; pos0: (1,)
    int32 tensor.  row: a scalar-leaf SlotSampling for this slot — the
    block's last-position logits are sampled (or argmaxed at temperature
    0) in the same step."""

    def step(params, cache, slot, tokens, pos0, bt_row, reset, row):
        sub = paged_slot_slice(cfg, cache, slot)
        sub = reset_paged_sub(cfg, sub, reset)
        full = dict(sub, pos=pos0, block_table=bt_row)
        out = T.forward(params, cfg, tokens, cache=full, paged_kernel=kernel)
        cache = paged_slot_update(cfg, cache, slot, sub)
        logits = out.logits[0, -1]
        scores = row_scores(logits, row)
        tok, margin = argmax_with_margin(scores[None])
        logprob = token_logprob(logits[None], tok)
        return tok[0], margin[0], logprob[0], cache

    return step

