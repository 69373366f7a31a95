"""Fused per-slot stochastic sampling for the port's serving engine.

The counterpart of ``repro.serving.sampling``: sampling is Gumbel-max over
filtered, temperature-scaled logits, so the sampled token is
``argmax(scores)`` and the top1-top2 gap of the same scores is the tie
margin ``completions_equivalent`` understands.  At ``temperature <= 0``
the scores ARE the raw fp32 logits.

Randomness is keyed per request exactly as in the JAX package, and the
noise is the same bits: a request's base key is JAX's threefry2x32 key of
its seed (``request_key`` / ``branch_key``), the key of its i-th emitted
token is ``fold_in(base, i)``, and the noise is
``jax.random.gumbel(fold_in(base, i), (V,))`` as jax 0.9.0 computes it
with ``jax_threefry_partitionable=True``:

- bits[i] = y0 ^ y1, (y0, y1) = threefry2x32(key, (0, i)) over the
  64-bit iota i (hi word 0 below 2**32 entries);
- u = max(tiny, f * (1 - tiny) + tiny), f = bitcast((bits >> 9) |
  0x3F800000) - 1;
- noise = -log(-log(u)), with ``log`` the polynomial that XLA's CPU
  backend emits (Cephes/Eigen ``plog``, its first three multiply-add
  layers and the exponent correction contracted to FMAs), so the port's
  noise is bit-identical to the reference's on the CPU.

All of it is plain tensor code (uint32 arithmetic carried in int64), run
on the logits' device; which rows sample is decided on the host from the
per-slot numpy arrays, so a greedy tick pays nothing.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy.

    temperature: 0 (default) is greedy argmax; > 0 samples from the
    scaled distribution.  top_k: keep only the k highest-probability
    tokens (0 = off).  top_p: keep the smallest set of tokens whose
    cumulative probability reaches top_p (1.0 = off).  seed: derives the
    request's PRNG key — same seed, same tokens, on every engine.
    branch: best-of-n branch index — branch b keys its noise off
    ``branch_key(seed, b)``; branch 0 keys off the plain seed key."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    branch: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0: {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off): {self.top_k}")
        if not 0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]: {self.top_p}")
        if self.branch < 0:
            raise ValueError(f"branch must be >= 0: {self.branch}")


GREEDY = SamplingParams()

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# ------------------------------------------------------------- threefry


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) on int64 tensors (or Python
    ints) holding uint32 values; returns (y0, y1), broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def request_key(seed: int) -> np.ndarray:
    """Host-side base key for a request: ``jax.random.PRNGKey(seed)``'s
    uint32 key data (a 32-bit seed pads its high word with zeros)."""
    seed = int(seed)
    hi = 0 if -2**31 <= seed < 2**31 else (seed >> 32) & _M32
    return np.array([hi, seed & _M32], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: threefry2x32(key, (0, data))."""
    y0, y1 = threefry2x32(int(key[0]), int(key[1]), 0, int(data) & _M32)
    return np.array([y0, y1], np.uint32)


def branch_key(seed: int, branch: int) -> np.ndarray:
    """Base key for branch `branch` of a best-of-n request:
    ``fold_in(seed_key, branch)`` for branch > 0, the plain seed key for
    branch 0."""
    if branch == 0:
        return request_key(seed)
    return fold_in(request_key(seed), branch)


def key_zeros() -> np.ndarray:
    """A zeroed key (don't-care / greedy)."""
    return np.zeros((2,), np.uint32)


class SlotSampling(NamedTuple):
    """Per-slot sampling state, batched over the slot pool (host numpy
    arrays).  ``step`` is the request's emit index — the fold_in counter,
    NOT the engine tick."""

    key: np.ndarray          # (n_slots, 2) uint32 base keys
    step: np.ndarray         # (n_slots,) int32 per-request emit index
    temperature: np.ndarray  # (n_slots,) float32; <= 0 means greedy
    top_k: np.ndarray        # (n_slots,) int32; 0 means off
    top_p: np.ndarray        # (n_slots,) float32; 1.0 means off


# -------------------------------------------------------- Gumbel noise


def _f32(hex_double: str) -> float:
    return struct.unpack(">d", bytes.fromhex(hex_double))[0]


# XLA CPU's float32 log: Cephes polynomial coefficients, as emitted
_LOG_P = [_f32(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "BFBFCBA9E0000000",
    "3FC23D37E0000000", "3FC999D580000000", "BFCFFFFF80000000",
    "3FBDE4A340000000", "BFC555CA00000000", "3FD5555540000000")]
_LOG_Q1 = _f32("BF2BD01060000000")
_LOG_Q2 = _f32("3FE6300000000000")
_SQRTHF = _f32("3FE6A09E60000000")
_TINY = float(np.finfo(np.float32).tiny)


def _fma32(a, b, c):
    """Single-rounding float32 a*b + c: the product is exact in float64;
    the float64 sum is exact unless it carries a residual, and then only
    a sum sitting exactly on a float32 rounding midpoint needs the
    residual's sign to round as a fused operation would."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    inf = torch.full_like(s, float("inf"))
    nudged = torch.nextafter(s, torch.where(err > 0, inf, -inf))
    return torch.where(mid & (err != 0), nudged, s).float()


def _xla_log(v):
    """float32 natural log, bit-identical to XLA's CPU backend for
    positive normal inputs (the only inputs the Gumbel noise feeds it)."""
    def c(x):
        return torch.tensor(x, dtype=torch.float32, device=v.device)
    x = torch.where(v <= _TINY, c(_TINY), v)
    bits = x.view(torch.int32)
    e = c(1.0) + ((bits >> 23) - 127).float()
    m = ((bits & -2139095041) | 1056964608).view(torch.float32)
    small = m < c(_SQRTHF)
    e = e - torch.where(small, c(1.0), c(0.0))
    x = (m - c(1.0)) + torch.where(small, m, c(0.0))
    x2 = x * x
    x3 = x2 * x
    p = [c(t) for t in _LOG_P]
    y = _fma32(x, p[0], p[1])
    y1 = _fma32(x, p[2], p[3])
    y2 = _fma32(x, p[4], p[5])
    y = _fma32(y, x, p[6])
    y1 = _fma32(y1, x, p[7])
    y2 = _fma32(y2, x, p[8])
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, c(_LOG_Q1) * e)
    x = x - c(0.5) * x2
    x = x + y
    return x + c(_LOG_Q2) * e


def gumbel_noise(keys, V: int, device) -> torch.Tensor:
    """(R, 2) uint32 step keys -> (R, V) float32 Gumbel noise, the bits
    of ``jax.random.gumbel(key, (V,), float32)``."""
    k = torch.as_tensor(np.asarray(keys, np.int64), device=device)
    i = torch.arange(V, dtype=torch.int64, device=device)[None, :]
    y0, y1 = threefry2x32(k[:, :1], k[:, 1:], torch.zeros_like(i), i)
    bits = (y0 ^ y1) >> 9 | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f * (1.0 - _TINY) + _TINY, _TINY)
    return -_xla_log(-_xla_log(u))


# ---------------------------------------------------------------- scores


def _filter_keep(scaled, top_k, top_p):
    """Boolean keep mask over (R, V) scaled logits: top-k first, then the
    nucleus cut over the RENORMALIZED top-k survivors (HF/vLLM order).
    Rank-based: a stable descending argsort breaks ties toward the lower
    index, matching argmax.  top_k (R,) int, top_p (R,) float tensors."""
    R, V = scaled.shape
    order = torch.argsort(-scaled, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ar = torch.arange(V, device=scaled.device).expand(R, V)
    ranks.scatter_(1, order, ar)
    k = torch.where(top_k > 0, torch.clamp_max(top_k, V),
                    torch.full_like(top_k, V))[:, None]
    srt = torch.gather(scaled, 1, order)
    probs = torch.softmax(torch.where(ar < k, srt, float("-inf")), dim=-1)
    below = (torch.cumsum(probs, dim=-1) - probs) < top_p[:, None]
    n_keep = torch.clamp_min(below.sum(dim=-1, keepdim=True), 1)
    n_p = torch.where(top_p[:, None] < 1.0, n_keep, torch.full_like(n_keep, V))
    return (ranks < k) & (ranks < n_p)


def batched_scores(logits, sampling: SlotSampling):
    """(B, V) logits + batched SlotSampling -> (B, V) fp32 scores.  Rows
    at temperature <= 0 are the raw fp32 logits; sampled rows are
    ``where(keep, logits / t + gumbel(fold_in(key, step)), -inf)``, with
    the top-k / top-p filter only where a row asks for it."""
    scores = logits.float()
    temp = np.asarray(sampling.temperature, np.float32)
    rows = np.nonzero(temp > 0)[0]
    if rows.size == 0:
        return scores
    dev = logits.device
    V = scores.shape[-1]
    keys = np.stack([fold_in(sampling.key[r], sampling.step[r])
                     for r in rows])
    idx = torch.as_tensor(rows, device=dev)
    t = torch.as_tensor(temp[rows], device=dev)[:, None]
    scaled = scores[idx] / t
    perturbed = scaled + gumbel_noise(keys, V, dev)
    top_k = np.asarray(sampling.top_k, np.int32)[rows]
    top_p = np.asarray(sampling.top_p, np.float32)[rows]
    if ((top_k > 0) | (top_p < 1.0)).any():
        keep = _filter_keep(scaled, torch.as_tensor(top_k, device=dev),
                            torch.as_tensor(top_p, device=dev))
        perturbed = torch.where(keep, perturbed, float("-inf"))
    scores = scores.clone()
    scores[idx] = perturbed
    return scores


def row_scores(logits, row: SlotSampling):
    """(V,) logits + scalar-leaf SlotSampling row -> (V,) scores (the
    chunked-prefill step samples one slot's first generated token)."""
    batch = SlotSampling(*(np.asarray(leaf)[None] for leaf in row))
    return batched_scores(logits[None], batch)[0]


def argmax_with_margin(scores):
    """(B, V) -> (argmax (B,), top1-top2 margin (B,) in fp32)."""
    top2 = torch.topk(scores.float(), 2, dim=-1).values
    return torch.argmax(scores, dim=-1), top2[:, 0] - top2[:, 1]


def token_logprob(logits, tok):
    """(B, V) raw logits + (B,) chosen tokens -> (B,) fp32 log-probability
    of each chosen token under the UNSCALED model distribution."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, 1, tok[:, None].long())[:, 0]
