"""Recurrent mixers of the port: Mamba2 (SSD) and RWKV6 (Finch), both over
one gated-linear-attention (GLA) scan — the counterpart of
``repro.models.ssm``:

    s_t = diag(exp(ld_t)) s_{t-1} + k_t v_t^T          state: (Dk, Dv) per head
    y_t = q_t . s_t                                     (Mamba2 read)
    y_t = q_t . s_{t-1} + (q_t . (u o k_t)) v_t         (RWKV6 read, u = bonus)

Only the no-cache forward is ported: every mixer takes ``state=None`` and
raises ``NotImplementedError`` for a carried state (decode and chunked
prefill against a cache belong to the serving of these archs, not ported
yet; see ROADMAP.md).  ``kernel`` is ``"torch"`` (the plain chunked scan,
the counterpart of JAX's ``use_pallas=False``) or ``"cuda"`` (the
hand-written scan kernel, the counterpart of ``use_pallas=True``; CPU
tensors take its plain version).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ref as ssm_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import check_kernel


def _no_state(state, what: str):
    if state is not None:
        raise NotImplementedError(
            f"{what} with a carried state (decode / cached prefill) is not "
            f"ported yet; the port runs the no-cache forward (state=None)")


def gla_scan_exact(q, k, v, log_decay, u=None, state=None):
    """Exact sequential reference.  q/k/ld: (B,S,H,Dk), v: (B,S,H,Dv).
    Returns (y (B,S,H,Dv) fp32, state (B,H,Dk,Dv) fp32)."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    s = (torch.zeros(B, H, Dk, Dv, dtype=torch.float32, device=q.device)
         if state is None else state.float())
    q, k, v, ld = (a.float() for a in (q, k, v, log_decay))
    uf = None if u is None else u.float()
    ys = []
    for t in range(S):
        qt, kt, vt, ldt = q[:, t], k[:, t], v[:, t], ld[:, t]  # (B,H,*)
        if uf is not None:   # RWKV6 reads s_{t-1}, plus the u-bonus
            y = torch.einsum("bhk,bhkv->bhv", qt, s)
            y = y + torch.einsum("bhk,bhk->bh", qt * uf, kt)[..., None] * vt
        s = s * torch.exp(ldt)[..., None] + kt[..., None] * vt[..., None, :]
        if uf is None:       # Mamba2 reads s_t
            y = torch.einsum("bhk,bhkv->bhv", qt, s)
        ys.append(y)
    return torch.stack(ys, dim=1), s


def gla_chunked(q, k, v, log_decay, u=None, state=None, chunk: int = 16,
                kernel: str = "torch"):
    """Chunked GLA scan.  Returns (y (B,S,H,Dv) in v's dtype, final_state
    (B,H,Dk,Dv) fp32).

    kernel="cuda" takes the reference's Pallas route (``ssm.py:64-68``):
    the scan kernel with chunk max(chunk, 64), from zero state only.
    kernel="torch" runs the plain chunked scan with chunk C = min(chunk,
    S), shrunk until it divides S, as the reference does; it takes a
    carried state.  The two agree to fp32 rounding."""
    check_kernel(kernel)
    if kernel == "cuda":
        return ssm_ops.ssm_scan(q, k, v, log_decay, u=u, state=state,
                                chunk=max(chunk, 64))
    S = q.shape[1]
    C = min(chunk, S)
    while S % C:
        C -= 1
    y, state = ssm_ref.chunked_scan(q, k, v, log_decay, u=u, state=state,
                                    chunk=C)
    return y.to(v.dtype), state


# ------------------------------------------------------------------ conv


def causal_conv1d(x, w, conv_state=None):
    """Depthwise causal conv.  x: (B, S, D), w: (W, D).  The W products
    are summed in x's dtype, in order, as the reference does.  Returns
    (y, new_conv_state): the last W-1 inputs."""
    _no_state(conv_state, "causal_conv1d")
    W = w.shape[0]
    B, S, D = x.shape
    xp = torch.cat([x.new_zeros(B, W - 1, D), x], dim=1)  # (B, S+W-1, D)
    y = sum(xp[:, i:i + S] * w[i] for i in range(W))
    return y.to(x.dtype), xp[:, -(W - 1):]


# ----------------------------------------------------------------- Mamba2


def _softplus(x):
    """jax.nn.softplus's form: log(exp(x) + 1) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba2_block(p, x, cfg: ModelConfig, state=None, kernel: str = "torch"):
    """Mamba2 (SSD) mixer, no-cache forward.  Returns (out, None).

    The scan's q and k are C and B broadcast over the heads, and its
    log-decay one scalar per (token, head) broadcast over the state dim:
    stride-0 views, which the scan kernel reads as given."""
    _no_state(state, "mamba2_block")
    B, S, D = x.shape
    di, N, hd = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_head_dim
    H = cfg.ssm_heads
    z = x @ p["w_z"]            # (B,S,di)
    xbc = torch.cat([x @ p["w_x"], x @ p["w_B"], x @ p["w_C"]], dim=-1)
    dt = x @ p["w_dt"]          # (B,S,H)
    xbc, _ = causal_conv1d(xbc, p["conv_w"])
    xbc = F.silu(xbc)
    xs, Bm, Cm = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    xs = xs.reshape(B, S, H, hd)
    dt = _softplus(dt.float() + p["dt_bias"].float())            # (B,S,H)
    ld = -torch.exp(p["A_log"].float()) * dt                     # <= 0
    ld = ld[..., None].expand(B, S, H, N)
    k = Bm[:, :, None, :].expand(B, S, H, N)
    q = Cm[:, :, None, :].expand(B, S, H, N)
    v = xs * dt[..., None].to(xs.dtype)  # dt rounded to the activation dtype

    d_skip = p["D_skip"].to(xs.dtype)[None, None, :, None]
    y, _ = gla_chunked(q, k, v, ld, kernel=kernel)
    y = y.to(xs.dtype) + xs * d_skip
    y = y.reshape(B, S, di)
    y = rms_norm_gated(y, z, p["norm_g"], cfg.norm_eps)
    return y @ p["out_proj"], None


def rms_norm_gated(y, z, g, eps):
    y = y * F.silu(z)
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return ((yf * torch.rsqrt(var + eps)) * g.float()).to(y.dtype)


# ------------------------------------------------------------------ RWKV6


def token_shift(x, shift_state=None):
    """xx_t = x_{t-1} (zeros at t=0).  x: (B,S,D).  Returns (xx, the last
    token: the next call's shift state)."""
    _no_state(shift_state, "token_shift")
    xx = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    return xx, x[:, -1]


def rwkv6_timemix(p, x, cfg: ModelConfig, state=None, kernel: str = "torch"):
    """RWKV6 time-mix with data-dependent decay (Finch), no-cache forward.
    Returns (out, None)."""
    _no_state(state, "rwkv6_timemix")
    B, S, D = x.shape
    hd = cfg.ssm_head_dim
    H = D // hd
    xx, _ = token_shift(x)
    dx = xx - x

    def mixed(name):
        return x + dx * p[f"mu_{name}"]

    r = mixed("r") @ p["w_r"]
    k = mixed("k") @ p["w_k"]
    v = mixed("v") @ p["w_v"]
    g = F.silu(mixed("g") @ p["w_g"])
    # data-dependent decay (low-rank): w = exp(-exp(w0 + tanh(x A) B))
    wx = torch.tanh(mixed("w") @ p["w_lora_a"]) @ p["w_lora_b"]
    ld = -torch.exp(torch.clamp(p["w0"].float() + wx.float(), -8.0, 4.0))

    rh = r.reshape(B, S, H, hd)
    kh = k.reshape(B, S, H, hd)
    vh = v.reshape(B, S, H, hd)
    ldh = ld.reshape(B, S, H, hd)
    u = p["u"].reshape(H, hd)
    y, _ = gla_chunked(rh, kh, vh, ldh, u=u, kernel=kernel)

    # per-head group norm (population variance, as jnp.var), then the gate
    yf = y.reshape(B, S, H, hd).float()
    mean = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, correction=0)
    yf = (yf - mean) * torch.rsqrt(var + 64e-5)
    y = (yf.reshape(B, S, D) * p["ln_w"].float()
         + p["ln_b"].float()).to(x.dtype)
    return (y * g) @ p["w_o"], None


def rwkv6_channelmix(p, x, cfg: ModelConfig, state=None):
    """RWKV6 channel-mix (squared-ReLU MLP with token shift), no-cache
    forward.  Returns (out, None)."""
    _no_state(state, "rwkv6_channelmix")
    xx, _ = token_shift(x)
    dx = xx - x
    kx = x + dx * p["mu_k"]
    rx = x + dx * p["mu_r"]
    kk = torch.square(torch.relu(kx @ p["w_kk"]))
    return torch.sigmoid(rx @ p["w_rr"]) * (kk @ p["w_vv"]), None
