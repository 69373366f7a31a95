"""Core transformer layers of the port: RMSNorm, RoPE, GQA attention
(qk-norm, QKV-bias, sliding window, paged KV cache), SwiGLU.

Plain functions over param dicts, as in ``repro.models.layers``; the
stacked leading layer axis is indexed away by models/transformer.py
before a layer's dict reaches these functions.

Differences from the JAX module, all deliberate:

- the paged cache is updated IN PLACE (JAX returned new pools): the new
  K/V rows are written into the pool tensors the caller passed, and the
  returned cache holds those same tensors;
- M-RoPE, chunked-local masking and the dense per-slot ring cache are not
  ported yet (see ROADMAP.md) and raise ``NotImplementedError``;
- ``paged_kernel`` is ``"torch"`` (the plain scatter + ring gather, the
  counterpart of JAX's "xla") or ``"cuda"`` (the hand-written paged
  attention kernel, the counterpart of "pallas").  There is no silent
  fallback between them: a block the kernel does not take raises;
- the no-cache forward's ``kernel`` is ``"torch"`` (``attention_impl``
  picks the materialized or the chunked online-softmax attention, as in
  the reference) or ``"cuda"`` (the hand-written flash-attention kernel,
  the counterpart of ``use_pallas=True``; CPU tensors take its plain
  version).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models.config import ModelConfig

KERNELS = ("torch", "cuda")  # the plain path, or the hand-written kernel
PAGED_KERNELS = KERNELS


def check_kernel(kernel: str, name: str = "kernel"):
    if kernel not in KERNELS:
        raise ValueError(f"{name}={kernel!r}: accepted values are {KERNELS}")


def rms_norm(x, gamma, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


# ------------------------------------------------------------------- RoPE


def rope_angles(positions, head_dim: int, theta: float):
    """positions: (..., S) -> cos/sin (..., S, head_dim/2), fp32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) or (S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------- attention


def _attn_mask(q_pos, k_pos, window: int = 0):
    """Boolean (..., S_q, S_k) mask: causal, optionally windowed."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def multi_head_attention(q, k, v, mask, dtype=None):
    """q: (B, S, H, hd), k/v: (B, T, KV, hd) with H = g*KV (GQA).

    Mirrors the JAX reference: the dots take the operands' storage dtype
    and accumulate in fp32 (``preferred_element_type``) — done here by
    widening exactly representable values to fp32 before the einsum —
    and the probabilities are rounded to v's dtype before the second
    dot."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    qh = q.reshape(B, S, KV, g, hd).float()
    scale = 1.0 / float(hd) ** 0.5
    logits = torch.einsum("bskgh,btkh->bkgst", qh, k.float()) * scale
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.full((), -1e30, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, S, H, hd).to(dtype or v.dtype)


def chunked_attention(q, k, v, q_pos, k_pos, cfg: ModelConfig, dtype=None):
    """Flash-style online-softmax attention over k-blocks of
    ``cfg.attention_block`` keys (shrunk until it divides T), plain torch:
    no (S, T) probability matrix is built; the working set is (S, block).
    The reference's ``chunked_attention`` step for step, the
    probabilities rounded to v's dtype before the PV product as there.
    q: (B, S, H, hd), k/v: (B, T, KV, hd); q_pos (B, S), k_pos (B, T) or
    (T,)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    bk = min(cfg.attention_block, T)
    while T % bk:
        bk -= 1
    n_blocks = T // bk
    scale = 1.0 / float(hd) ** 0.5
    qh = q.reshape(B, S, KV, g, hd).float()
    kb = k.reshape(B, n_blocks, bk, KV, hd)
    vb = v.reshape(B, n_blocks, bk, KV, hd)
    kpb = (k_pos.reshape(B, n_blocks, bk) if k_pos.ndim == 2 else
           k_pos.reshape(n_blocks, bk)[None].expand(B, n_blocks, bk))
    m = torch.full((B, KV, g, S), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, g, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, KV, g, hd), dtype=torch.float32,
                      device=q.device)
    neg = torch.full((), -1e30, device=q.device)
    for j in range(n_blocks):
        kj, vj = kb[:, j], vb[:, j]
        s = torch.einsum("bskgh,btkh->bkgst", qh, kj.float()) * scale
        blk_mask = _attn_mask(q_pos, kpb[:, j], cfg.sliding_window)
        s = torch.where(blk_mask[:, None, None, :, :], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkh->bskgh", p.to(vj.dtype).float(),
                          vj.float())
        acc = acc * alpha.movedim(-1, 1)[..., None] + pv
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = acc / l.movedim(-1, 1)[..., None]
    return out.reshape(B, S, H, hd).to(dtype or v.dtype)


def _paged_plain(q, k, v, cache, abs_pos, positions, window):
    """The plain paged path (JAX's "xla" branch): scatter the S new rows
    into the pool through the block table, gather each lane's whole
    logical ring back, mask by ring position validity."""
    B, S = q.shape[:2]
    pool_k, pool_v, bt = cache["k"], cache["v"], cache["block_table"]
    psz = pool_k.shape[1]
    T = bt.shape[1] * psz
    b_idx = torch.arange(B, device=q.device)[:, None]
    slots = abs_pos % T
    w_idx = (bt[b_idx, slots // psz] * psz + slots % psz).reshape(-1).long()
    flat_k = pool_k.view((-1,) + tuple(pool_k.shape[2:]))
    flat_v = pool_v.view((-1,) + tuple(pool_v.shape[2:]))
    # idle lanes all write the null page 0: duplicate indices there, and
    # whichever write lands is masked garbage
    flat_k.index_copy_(0, w_idx, k.reshape((-1,) + k.shape[2:])
                       .to(pool_k.dtype))
    flat_v.index_copy_(0, w_idx, v.reshape((-1,) + v.shape[2:])
                       .to(pool_v.dtype))
    ring = torch.arange(T, device=q.device)
    g_idx = bt[:, ring // psz] * psz + ring % psz            # (B, T)
    ck, cv = flat_k[g_idx], flat_v[g_idx]                    # (B, T, KV, hd)
    # absolute position held by ring slot i after the writes: the largest
    # value congruent to i (mod T) that is <= the last written position
    last = abs_pos[:, -1:]
    k_pos = last - ((last - ring[None, :]) % T)              # (B, T)
    mask = _attn_mask(positions, k_pos, window)
    mask &= (k_pos >= 0)[:, None, :]
    # the ring is read in the pool's dtype, as the kernel and ref.py read
    # it.  (The JAX "xla" branch casts it to the activation dtype first,
    # which at bf16 rounds the softmax probabilities to bf16 before the PV
    # product; K/V themselves are bf16 values either way.  That rounding
    # moves bf16 logits by a few ulps and split the kernel and plain
    # paths' completions on the card; in fp32 both forms are the same.)
    return multi_head_attention(q, ck, cv, mask, dtype=q.dtype)


def attention_block(p, x, cfg: ModelConfig, *, positions=None, cache=None,
                    paged_kernel: str = "torch", kernel: str = "torch"):
    """GQA attention with RoPE, qk-norm, bias and window masking.

    cache: None for a full-sequence forward (self-attention over x), or
    a paged decode cache {"k": (n_pages, page_size, KV, hd), "v": ...,
    "block_table": (B, P) int32 page ids, "pos": (B,) int32 positions}.
    Returns (out, new_cache); the pools in new_cache are the pools that
    were passed, updated in place with the S new rows.

    kernel (no-cache forward): "cuda" runs the flash-attention kernel
    where the reference's ``use_pallas`` branch does (causal, with the
    config's window; the kernel masks by sequence index, as the
    reference's does); "torch" takes ``cfg.attention_impl``: "chunked"
    (online softmax over key blocks) or else the materialized softmax.
    paged_kernel (paged cache): "torch" or "cuda", see the module note."""
    if cfg.mrope or cfg.chunked_attention:
        raise NotImplementedError(
            "M-RoPE and chunked-local attention are not ported yet")
    check_kernel(paged_kernel, "paged_kernel")
    check_kernel(kernel)
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    window = cfg.sliding_window
    if cache is None:
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device)[None].expand(B, S)
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if kernel == "cuda":
            out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
        elif cfg.attention_impl == "chunked":
            out = chunked_attention(q, k, v, positions, positions, cfg)
        else:
            out = multi_head_attention(
                q, k, v, _attn_mask(positions, positions, window))
        new_cache = None
    else:
        if "block_table" not in cache:
            raise NotImplementedError(
                "the dense per-slot ring cache is not ported yet; pass a "
                "paged cache (block_table)")
        pos = cache["pos"]
        abs_pos = pos[:, None] + torch.arange(S, dtype=torch.int32,
                                              device=x.device)[None, :]
        default_pos = positions is None
        if default_pos:
            positions = abs_pos
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if paged_kernel == "cuda":
            out, _, _ = pa_ops.paged_attention_update(
                q, k, v, cache["k"], cache["v"], cache["block_table"],
                abs_pos[:, -1], window=window,
                q_positions=None if default_pos else positions)
        else:
            out = _paged_plain(q, k, v, cache, abs_pos, positions, window)
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + S}

    out = out.reshape(B, S, H * hd) @ p["wo"]
    return out, new_cache


# ------------------------------------------------------------------- MLP


def swiglu_mlp(p, x):
    gate = F.silu(x @ p["w_gate"])
    up = x @ p["w_up"]
    return (gate * up) @ p["w_down"]
