"""Parameter initialization for the port, and the bridge that carries JAX
parameters across.

The tree has the JAX package's paths (``repro.models.params``): nested
dicts ``embed.tok``, ``lm_head`` (untied only), ``final_norm`` and
``layers`` — for dense decoders ``{ln1, attn.{wq, wk, wv, wo, bq?, bk?,
bv?, q_norm?, k_norm?}, ln2, mlp.{w_gate, w_up, w_down}}``, for RWKV6
``{ln1, rwkv.{mu_*, w_*, w_lora_*, w0, u, ln_w, ln_b, cm.{...}}, ln2}``,
for Mamba2 and the hybrid ``{ln1, mamba.{w_z, w_x, w_B, w_C, w_dt,
conv_w, dt_bias, A_log, D_skip, norm_g, out_proj}}`` — every ``layers``
leaf stacked with a leading layer axis ((groups, per group) for the
hybrid, whose ``shared`` attention + MLP block is unstacked).  Weights
are stored ``(in, out)`` as in the JAX package, so ``x @ w`` reads the
same in both.

The two packages draw different random numbers from the same seed, so a
test that holds the port to the reference makes the weights once (in JAX,
or with numpy) and hands them over with ``params_from_jax``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name ("bfloat16", "float32")."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r}: accepted values are "
                         f"{tuple(_DTYPES)}")
    return _DTYPES[name]


def check_dense(cfg: ModelConfig):
    """The paged serving stack covers dense attention decoders only."""
    if cfg.arch_type != "dense" or cfg.block_kind != "attention" \
            or cfg.num_codebooks != 1:
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense attention decoders "
            f"(arch_type='dense'); got arch_type={cfg.arch_type!r}, "
            f"block_kind={cfg.block_kind!r}")


PORTED_ARCHS = {"dense": ("attention",), "ssm": ("rwkv6", "mamba2"),
                "hybrid": ("hybrid",)}


def check_arch(cfg: ModelConfig):
    """The families whose parameters and no-cache forward are ported:
    dense attention decoders, RWKV6 and Mamba2 stacks, and the hybrid
    (Mamba2 groups with one shared attention block)."""
    if cfg.block_kind not in PORTED_ARCHS.get(cfg.arch_type, ()) \
            or cfg.is_moe or cfg.num_codebooks != 1:
        raise NotImplementedError(
            f"{cfg.name}: the port covers arch_type/block_kind "
            f"{PORTED_ARCHS} without MoE or codebooks; got "
            f"arch_type={cfg.arch_type!r}, block_kind={cfg.block_kind!r}")


class _Draw:
    """Leaves drawn from one generator in fp32 on its device, moved to
    `device` in the config's dtype (the reference casts even its fp32
    ``init=`` leaves to ``cfg.dtype``).  On the meta device nothing is
    drawn: the leaves carry shapes and dtypes only."""

    def __init__(self, generator, device, dtype):
        self.gen, self.device, self.dtype = generator, device, dtype
        self.meta = torch.device(device).type == "meta"

    def cast(self, x):
        return x.to(device=self.device, dtype=self.dtype)

    def _fp32(self, shape, draw):
        if self.meta:
            return torch.empty(shape, device="meta", dtype=torch.float32)
        return draw(shape, generator=self.gen, device=self.gen.device,
                    dtype=torch.float32)

    def normal(self, shape, scale):
        return self.cast(self._fp32(shape, torch.randn) * scale)

    def uniform(self, shape, lo, hi):
        return self._fp32(shape, torch.rand) * (hi - lo) + lo

    def const(self, shape, value):
        return torch.full(shape, value, device=self.device, dtype=self.dtype)


def _attn_params(d: _Draw, cfg: ModelConfig, L):
    """Attention leaves with a leading (L,) axis (L = () for none)."""
    D, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    s_in = 1.0 / math.sqrt(D)
    s_out = s_in / math.sqrt(2 * cfg.n_layers)
    attn = {"wq": d.normal(L + (D, qd), s_in),
            "wk": d.normal(L + (D, kvd), s_in),
            "wv": d.normal(L + (D, kvd), s_in),
            "wo": d.normal(L + (qd, D), s_out)}
    if cfg.qkv_bias:
        attn.update(bq=d.const(L + (qd,), 0.0), bk=d.const(L + (kvd,), 0.0),
                    bv=d.const(L + (kvd,), 0.0))
    if cfg.qk_norm:
        attn.update(q_norm=d.const(L + (hd,), 1.0),
                    k_norm=d.const(L + (hd,), 1.0))
    return attn


def _out_scale(cfg: ModelConfig, fan_in: int) -> float:
    """The reference's scale of a block's output projection."""
    return 1.0 / math.sqrt(fan_in) / math.sqrt(2 * cfg.n_layers)


def _mlp_params(d: _Draw, cfg: ModelConfig, L):
    D, F = cfg.d_model, cfg.d_ff
    s_in = 1.0 / math.sqrt(D)
    return {"w_gate": d.normal(L + (D, F), s_in),
            "w_up": d.normal(L + (D, F), s_in),
            "w_down": d.normal(L + (F, D), _out_scale(cfg, F))}


def _mamba_params(d: _Draw, cfg: ModelConfig, L):
    D, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_heads
    W = cfg.ssm_conv_width
    s_in = 1.0 / math.sqrt(D)
    # dt bias: softplus^-1 of a dt log-uniform in [1e-3, 1e-1]; A = -exp(A_log)
    # with exp(A_log) uniform in [1, 16] (the reference's mamba2 init)
    dt = torch.exp(d.uniform(L + (H,), math.log(1e-3), math.log(1e-1)))
    a_log = torch.log(d.uniform(L + (H,), 1.0, 16.0))
    return {
        "w_z": d.normal(L + (D, di), s_in), "w_x": d.normal(L + (D, di), s_in),
        "w_B": d.normal(L + (D, N), s_in), "w_C": d.normal(L + (D, N), s_in),
        "w_dt": d.normal(L + (D, H), s_in),
        "conv_w": d.normal(L + (W, di + 2 * N), 1.0 / math.sqrt(W)),
        "dt_bias": d.cast(dt + torch.log(-torch.expm1(-dt))),
        "A_log": d.cast(a_log),
        "D_skip": d.const(L + (H,), 1.0),
        "norm_g": d.const(L + (di,), 1.0),
        "out_proj": d.normal(L + (di, D), _out_scale(cfg, di)),
    }


def _rwkv_params(d: _Draw, cfg: ModelConfig, L):
    D, F = cfg.d_model, cfg.d_ff
    lora = 64
    s_in = 1.0 / math.sqrt(D)
    p = {f"mu_{nm}": d.const(L + (D,), 0.5) for nm in "rkvgw"}
    p.update({f"w_{nm}": d.normal(L + (D, D), s_in) for nm in "rkvg"})
    p["w_o"] = d.normal(L + (D, D), s_in / math.sqrt(2 * cfg.n_layers))
    p["w_lora_a"] = d.normal(L + (D, lora), s_in)
    p["w_lora_b"] = d.normal(L + (lora, D), 1.0 / math.sqrt(lora))
    p["w0"] = d.cast(torch.linspace(-6.0, -0.5, D).repeat(L + (1,)))
    p["u"] = d.const(L + (D,), 0.5)
    p["ln_w"] = d.const(L + (D,), 1.0)
    p["ln_b"] = d.const(L + (D,), 0.0)
    p["cm"] = {"mu_k": d.const(L + (D,), 0.5), "mu_r": d.const(L + (D,), 0.5),
               "w_kk": d.normal(L + (D, F), s_in),
               "w_vv": d.normal(L + (F, D), _out_scale(cfg, F)),
               "w_rr": d.normal(L + (D, D), s_in)}
    return p


def _layer_params(d: _Draw, cfg: ModelConfig, L):
    D = cfg.d_model
    if cfg.block_kind == "attention":
        return {"ln1": d.const(L + (D,), 1.0), "attn": _attn_params(d, cfg, L),
                "ln2": d.const(L + (D,), 1.0), "mlp": _mlp_params(d, cfg, L)}
    if cfg.block_kind == "rwkv6":
        return {"ln1": d.const(L + (D,), 1.0), "rwkv": _rwkv_params(d, cfg, L),
                "ln2": d.const(L + (D,), 1.0)}
    return {"ln1": d.const(L + (D,), 1.0), "mamba": _mamba_params(d, cfg, L)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda"):
    """Random parameters, drawn from `generator`, with the reference's tree
    (``repro.models.params.init_params``): paths, shapes and dtypes.

    Scales follow the reference (normal * scale; norms at one, biases at
    zero; Mamba2's dt_bias, A_log and D_skip, RWKV6's w0 linspace, u and
    token-shift mixes at 0.5).  Each leaf is drawn in fp32 on the
    generator's device, then moved to `device` in ``cfg.dtype``;
    device="meta" gives the tree's shapes and dtypes without drawing (the
    counterpart of the reference's ``abstract_params``).  Layer
    leaves are stacked (L, ...) — for the hybrid (G, hybrid_attn_every,
    ...), with one unstacked ``shared`` attention + MLP block."""
    check_arch(cfg)
    d = _Draw(generator, device, torch_dtype(cfg.dtype))
    D, V = cfg.d_model, cfg.vocab_size
    hybrid = cfg.block_kind == "hybrid" and cfg.hybrid_attn_every
    L = ((cfg.n_layers // cfg.hybrid_attn_every, cfg.hybrid_attn_every)
         if hybrid else (cfg.n_layers,))
    layers = _layer_params(d, cfg, L)  # drawn first, as it always was
    params = {
        "embed": {"tok": d.normal((V, D), 0.02)},
        "final_norm": d.const((D,), 1.0),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = d.normal((D, V), 1.0 / math.sqrt(D))
    if hybrid:
        params["shared"] = {"ln1": d.const((D,), 1.0),
                            "attn": _attn_params(d, cfg, ()),
                            "ln2": d.const((D,), 1.0),
                            "mlp": _mlp_params(d, cfg, ())}
    return params


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: carry the raw bits over
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(tree, device="cuda"):
    """A JAX parameter tree, its leaves converted to numpy (for example
    ``jax.tree.map(np.asarray, params)``), as the port's tree of tensors
    on `device`.  Paths, shapes and dtypes (bf16 included) carry over
    unchanged, the stacked leading layer axis with them."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _to_tensor(tree, device)

