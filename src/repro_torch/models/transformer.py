"""Decoder of the port: embedding -> layers -> head.

The counterpart of ``repro.models.transformer`` for the dense, RWKV6,
Mamba2 and hybrid (zamba2) families:

- a full-sequence forward (cache=None) for every family, the prefill and
  scoring path behind ``serving.serve_step.make_prefill_step``; for the
  hybrid, each group of ``hybrid_attn_every`` Mamba2 layers is followed by
  the one *shared* attention + MLP block (a single parameter copy, default
  positions);
- a decode forward against a paged KV cache (S >= 1 new tokens per slot;
  S > 1 is chunked prefill), for dense decoders only: the recurrent
  families' decode raises ``NotImplementedError``.

The JAX module runs ``lax.scan`` over the stacked layer parameters; here a
Python loop indexes the leading layer axis.  The paged pools are updated
in place (see models/layers.py).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import layers as Lyr
from repro_torch.models import ssm as Ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import check_arch


class ForwardOut(NamedTuple):
    logits: torch.Tensor        # (B, S, V)
    cache: Any                  # None for a full-sequence forward


def layer_params(tree, i):
    """Layer i's parameter dict: every stacked leaf indexed at i (an int,
    or a tuple (group, layer) for the hybrid's stacking)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def _attn_mlp_block(p, h, cfg: ModelConfig, *, positions, cache,
                    paged_kernel, kernel):
    a, new_cache = Lyr.attention_block(
        p["attn"], Lyr.rms_norm(h, p["ln1"], cfg.norm_eps), cfg,
        positions=positions, cache=cache, paged_kernel=paged_kernel,
        kernel=kernel)
    h = h + a
    x2 = Lyr.rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + Lyr.swiglu_mlp(p["mlp"], x2), new_cache


def _rwkv_block(p, h, cfg: ModelConfig, *, kernel):
    a, _ = Ssm.rwkv6_timemix(
        p["rwkv"], Lyr.rms_norm(h, p["ln1"], cfg.norm_eps), cfg,
        kernel=kernel)
    h = h + a
    m, _ = Ssm.rwkv6_channelmix(
        p["rwkv"]["cm"], Lyr.rms_norm(h, p["ln2"], cfg.norm_eps), cfg)
    return h + m


def _mamba_block(p, h, cfg: ModelConfig, *, kernel):
    a, _ = Ssm.mamba2_block(
        p["mamba"], Lyr.rms_norm(h, p["ln1"], cfg.norm_eps), cfg,
        kernel=kernel)
    return h + a


def embed_inputs(params, cfg: ModelConfig, tokens):
    """tokens: (B, S) integer ids -> (B, S, D) embeddings."""
    return params["embed"]["tok"][tokens]


def unembed(params, cfg: ModelConfig, h):
    if cfg.tie_embeddings:
        return h @ params["embed"]["tok"].T
    return h @ params["lm_head"]


def _no_cache_layers(params, cfg: ModelConfig, h, positions, kernel):
    """Every layer of a full-sequence forward."""
    if cfg.block_kind == "attention":
        for i in range(cfg.n_layers):
            h, _ = _attn_mlp_block(layer_params(params["layers"], i), h, cfg,
                                   positions=positions, cache=None,
                                   paged_kernel="torch", kernel=kernel)
    elif cfg.block_kind == "rwkv6":
        for i in range(cfg.n_layers):
            h = _rwkv_block(layer_params(params["layers"], i), h, cfg,
                            kernel=kernel)
    elif cfg.block_kind == "hybrid" and cfg.hybrid_attn_every:
        every = cfg.hybrid_attn_every
        for g in range(cfg.n_layers // every):
            for i in range(every):
                h = _mamba_block(layer_params(params["layers"], (g, i)), h,
                                 cfg, kernel=kernel)
            h, _ = _attn_mlp_block(params["shared"], h, cfg,
                                   positions=positions, cache=None,
                                   paged_kernel="torch", kernel=kernel)
    else:  # mamba2, or a hybrid with no shared block
        for i in range(cfg.n_layers):
            h = _mamba_block(layer_params(params["layers"], i), h, cfg,
                             kernel=kernel)
    return h


def forward(params, cfg: ModelConfig, tokens, *, positions=None, cache=None,
            paged_kernel: str = "torch",
            kernel: str = "torch") -> ForwardOut:
    """Full sequence (cache=None) or decode against a paged cache.

    cache: {"layers": {"k": (L, n_pages, page_size, KV, hd), "v": ...},
    "pos": (B,) int32, "block_table": (B, P) int32} — the block table is
    shared by every layer's pool.  The returned cache holds the same pool
    tensors, updated in place, and "pos" advanced by S.  Dense decoders
    only.

    kernel (cache=None): "torch" (the plain attention and scan) or "cuda"
    (the flash-attention and scan kernels) — the counterpart of the
    reference's ``use_pallas``.  paged_kernel (with a cache): "torch"
    (plain scatter + ring gather) or "cuda" (the paged-attention kernel).
    CPU tensors take the kernels' plain versions."""
    check_arch(cfg)
    Lyr.check_kernel(kernel)
    h = embed_inputs(params, cfg, tokens)
    if cache is None:
        h = _no_cache_layers(params, cfg, h, positions, kernel)
        h = Lyr.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return ForwardOut(logits=unembed(params, cfg, h), cache=None)

    if cfg.block_kind != "attention":
        raise NotImplementedError(
            f"{cfg.name}: decode of the {cfg.block_kind} family (recurrent "
            f"state caches) is not ported yet; the port runs its no-cache "
            f"forward (cache=None)")
    for i in range(cfg.n_layers):
        cache_l = {"k": cache["layers"]["k"][i],
                   "v": cache["layers"]["v"][i],
                   "pos": cache["pos"],
                   "block_table": cache["block_table"]}
        h, _ = _attn_mlp_block(layer_params(params["layers"], i), h, cfg,
                               positions=positions, cache=cache_l,
                               paged_kernel=paged_kernel, kernel=kernel)
    h = Lyr.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, cfg, h)
    new_cache = {"layers": cache["layers"],
                 "pos": cache["pos"] + tokens.shape[1]}
    return ForwardOut(logits=logits, cache=new_cache)
