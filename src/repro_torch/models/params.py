"""Parameter initialization for the port, and the bridge that carries JAX
parameters across.

The tree has the JAX package's paths (``repro.models.params``): nested
dicts ``embed.tok``, ``lm_head`` (untied only), ``final_norm`` and
``layers.{ln1, attn.{wq, wk, wv, wo, bq?, bk?, bv?, q_norm?, k_norm?}, ln2,
mlp.{w_gate, w_up, w_down}}``, every ``layers`` leaf stacked with a
leading layer axis.  Weights are stored ``(in, out)`` as in the JAX
package, so ``x @ w`` reads the same in both.

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
    if cfg.arch_type != "dense" or cfg.block_kind != "attention" \
            or cfg.num_codebooks != 1:
        raise NotImplementedError(
            f"{cfg.name}: the port covers dense attention decoders "
            f"(arch_type='dense'); got arch_type={cfg.arch_type!r}, "
            f"block_kind={cfg.block_kind!r}")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda"):
    """Random parameters for a dense decoder, drawn from `generator`.

    Scales follow ``repro.models.params.init_params`` (normal * scale,
    norms at one, biases at zero).  Each leaf is drawn in fp32 on the
    generator's device, then moved to `device` in ``cfg.dtype``."""
    check_dense(cfg)
    dtype = torch_dtype(cfg.dtype)
    gdev = generator.device
    D, V, L, F = cfg.d_model, cfg.vocab_size, cfg.n_layers, cfg.d_ff
    qd, kvd, hd = cfg.q_dim, cfg.kv_dim, cfg.head_dim

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=gdev,
                        dtype=torch.float32) * scale
        return x.to(device=device, dtype=dtype)

    def const(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    s_in = 1.0 / math.sqrt(D)
    s_out = s_in / math.sqrt(2 * L)
    attn = {"wq": normal((L, D, qd), s_in), "wk": normal((L, D, kvd), s_in),
            "wv": normal((L, D, kvd), s_in), "wo": normal((L, qd, D), s_out)}
    if cfg.qkv_bias:
        attn.update(bq=const((L, qd), 0.0), bk=const((L, kvd), 0.0),
                    bv=const((L, kvd), 0.0))
    if cfg.qk_norm:
        attn.update(q_norm=const((L, hd), 1.0), k_norm=const((L, hd), 1.0))
    mlp = {"w_gate": normal((L, D, F), s_in), "w_up": normal((L, D, F), s_in),
           "w_down": normal((L, F, D),
                            1.0 / math.sqrt(F) / math.sqrt(2 * L))}
    params = {
        "embed": {"tok": normal((V, D), 0.02)},
        "final_norm": const((D,), 1.0),
        "layers": {"ln1": const((L, D), 1.0), "attn": attn,
                   "ln2": const((L, D), 1.0), "mlp": mlp},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), 1.0 / math.sqrt(D))
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

