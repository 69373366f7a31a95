"""Dense decoder of the port: embedding -> layers -> head.

The counterpart of ``repro.models.transformer`` for ``arch_type="dense"``:
a full-sequence forward (cache=None) and a decode forward against a paged
KV cache (S >= 1 new tokens per slot; S > 1 is chunked prefill).  The JAX
module runs ``lax.scan`` over the stacked layer parameters; here a Python
loop indexes the leading layer axis.  The paged pools are updated in
place (see models/layers.py).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import layers as Lyr
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import check_dense


class ForwardOut(NamedTuple):
    logits: torch.Tensor        # (B, S, V)
    cache: Any                  # None for a full-sequence forward


def layer_params(tree, i: int):
    """Layer i's parameter dict: every stacked leaf indexed at i."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def _attn_mlp_block(p, h, cfg: ModelConfig, *, positions, cache,
                    paged_kernel):
    a, new_cache = Lyr.attention_block(
        p["attn"], Lyr.rms_norm(h, p["ln1"], cfg.norm_eps), cfg,
        positions=positions, cache=cache, paged_kernel=paged_kernel)
    h = h + a
    x2 = Lyr.rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + Lyr.swiglu_mlp(p["mlp"], x2), new_cache


def embed_inputs(params, cfg: ModelConfig, tokens):
    """tokens: (B, S) integer ids -> (B, S, D) embeddings."""
    return params["embed"]["tok"][tokens]


def unembed(params, cfg: ModelConfig, h):
    if cfg.tie_embeddings:
        return h @ params["embed"]["tok"].T
    return h @ params["lm_head"]


def forward(params, cfg: ModelConfig, tokens, *, positions=None, cache=None,
            paged_kernel: str = "torch") -> ForwardOut:
    """Full sequence (cache=None) or decode against a paged cache.

    cache: {"layers": {"k": (L, n_pages, page_size, KV, hd), "v": ...},
    "pos": (B,) int32, "block_table": (B, P) int32} — the block table is
    shared by every layer's pool.  The returned cache holds the same pool
    tensors, updated in place, and "pos" advanced by S.

    paged_kernel: "torch" (plain scatter + ring gather) or "cuda" (the
    hand-written paged-attention kernel; CPU tensors take its plain
    version)."""
    check_dense(cfg)
    h = embed_inputs(params, cfg, tokens)
    decode = cache is not None
    for i in range(cfg.n_layers):
        cache_l = None
        if decode:
            cache_l = {"k": cache["layers"]["k"][i],
                       "v": cache["layers"]["v"][i],
                       "pos": cache["pos"],
                       "block_table": cache["block_table"]}
        h, _ = _attn_mlp_block(layer_params(params["layers"], i), h, cfg,
                               positions=positions, cache=cache_l,
                               paged_kernel=paged_kernel)
    h = Lyr.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, cfg, h)
    new_cache = None
    if decode:
        new_cache = {"layers": cache["layers"],
                     "pos": cache["pos"] + tokens.shape[1]}
    return ForwardOut(logits=logits, cache=new_cache)
