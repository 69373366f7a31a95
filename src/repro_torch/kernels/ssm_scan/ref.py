"""Plain PyTorch versions of the chunked GLA scan — the port's
counterparts of ``repro.kernels.ssm_scan.ref`` and of the chunked body of
``repro.models.ssm.gla_chunked``.

``chunked_scan`` is that body: per chunk of C rows, the pairwise decays
exp(cum_i - cum_j) (cum the chunk's own inclusive cumsum of ld; cum - ld
on the query side in bonus mode) with -inf above the diagonal (and on it
in bonus mode), so every exponent is <= 0, then the carried-state read
and the state update.  ``reference_scan`` runs it with the kernel's
16-row sub-chunks over a sequence zero-padded to a multiple of 16 (a
padded row adds nothing to y or the state), which is the arithmetic the
CUDA kernel does.  ``ops.py`` runs it for tensors on the CPU, and
chip_smoke.py holds the kernel against it on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SUB = 16  # the kernel's sub-chunk rows (the TPU kernel's SUB)


def chunked_scan(q, k, v, ld, u=None, state=None, chunk: int = SUB):
    """q/k/ld: (B, S, H, Dk), v: (B, S, H, Dv) with S % chunk == 0; u:
    (H, Dk) or None (Mamba2 read); state: (B, H, Dk, Dv) fp32 or None
    (zero).  Returns (y (B, S, H, Dv) fp32, final state (B, H, Dk, Dv))."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    C = chunk
    if S % C:
        raise ValueError(f"S={S} must be a multiple of the chunk {C}")
    n = S // C

    def to_chunks(a):  # (n, B, C, H, *)
        return a.float().reshape(B, n, C, H, -1).transpose(0, 1)

    qc, kc, vc, ldc = map(to_chunks, (q, k, v, ld))
    s = (torch.zeros(B, H, Dk, Dv, dtype=torch.float32, device=q.device)
         if state is None else state.float())
    uf = None if u is None else u.float()
    causal = torch.tril(torch.ones(C, C, dtype=torch.bool, device=q.device),
                        0 if u is None else -1)
    ys = []
    for qi, ki, vi, ldi in zip(qc, kc, vc, ldc):   # (B, C, H, *)
        cum = torch.cumsum(ldi, dim=1)               # inclusive
        # bonus (RWKV) reads s_{t-1}: query-side decay excludes step t
        cum_q = cum - ldi if uf is not None else cum
        diff = cum_q[:, :, None] - cum[:, None, :]   # (B, C, C, H, Dk)
        diff = diff.masked_fill(~causal[None, :, :, None, None],
                                float("-inf"))
        A = torch.einsum("bihk,bjhk,bijhk->bhij", qi, ki, torch.exp(diff))
        y = torch.einsum("bhij,bjhv->bihv", A, vi)
        y = y + torch.einsum("bihk,bhkv->bihv", qi * torch.exp(cum_q), s)
        if uf is not None:
            y = y + torch.einsum("bihk,bihk->bih", qi * uf, ki)[..., None] \
                * vi
        total = cum[:, -1]                           # (B, H, Dk)
        k_carry = ki * torch.exp(total[:, None] - cum)
        s = (s * torch.exp(total)[..., None]
             + torch.einsum("bihk,bihv->bhkv", k_carry, vi))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, S, H, Dv)
    return y, s


def reference_scan(q, k, v, ld, u=None):
    """The kernel's arithmetic for any S: 16-row sub-chunks from zero
    state.  q/k/ld: (B, S, H, Dk), v: (B, S, H, Dv).  Returns y
    (B, S, H, Dv) in v's dtype."""
    S = q.shape[1]
    pad = (-S) % SUB
    if pad:
        q, k, v, ld = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v, ld))
    y, _ = chunked_scan(q, k, v, ld, u=u, chunk=SUB)
    return y[:, :S].to(v.dtype)
