"""Model configuration — one dataclass covering all assigned architecture
families (dense / MoE / SSM / hybrid / VLM / audio).

A verbatim copy of ``repro.models.config``: the JAX package reaches it
through ``repro/models/__init__.py``, which imports JAX, so the port keeps
its own.  The port runs the dense, RWKV6, Mamba2 and hybrid families
(``models.params.check_arch``); the other fields are kept so configs read
the same in both packages."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    citation: str = ""

    # --- attention options
    qkv_bias: bool = False          # qwen1.5 / qwen2 QKV bias
    qk_norm: bool = False           # qwen3 per-head RMSNorm on q,k
    rope_theta: float = 1e6
    sliding_window: int = 0         # >0: windowed attention (ring KV cache)
    chunked_attention: int = 0      # >0: llama4-style chunked-local attention
    chunked_global_every: int = 4   # every Nth layer stays global (llama4: 4)
    mrope: bool = False             # qwen2-vl M-RoPE
    mrope_sections: tuple = (16, 24, 24)  # halves of head_dim split (t,h,w)

    # --- MoE
    n_experts: int = 0
    n_experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 512       # dispatch-einsum token-group size
    router_aux_loss: float = 0.01   # load-balance loss weight

    # --- recurrent blocks
    block_kind: str = "attention"   # attention | mamba2 | rwkv6 | hybrid
    ssm_state_dim: int = 0          # mamba2 state size N
    ssm_head_dim: int = 64          # mamba2 / rwkv6 head dim
    ssm_expand: int = 2             # mamba2 d_inner = expand * d_model
    ssm_conv_width: int = 4
    hybrid_attn_every: int = 0      # zamba2: shared attn block every N layers

    # --- modality frontends (STUBS per assignment: input_specs feeds
    # precomputed embeddings/token frames of the right shape)
    frontend: str = ""              # "" | "audio" | "vision"
    num_codebooks: int = 1          # musicgen: EnCodec codebooks
    n_patches: int = 0              # vlm: vision patch embeddings prepended

    # --- misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"         # params/activations dtype
    remat: bool = True              # activation checkpointing over layers
    remat_policy: str = "full"      # full | dots | none (what to save)
    scan_layers: bool = True        # lax.scan over stacked layer params

    # --- perf levers (see EXPERIMENTS.md §Perf)
    attention_impl: str = "naive"   # naive (materialized) | chunked (online
    #                                 softmax over k-blocks, flash-style)
    attention_block: int = 1024     # k-block for attention_impl=chunked
    shard_flat_heads: bool = False  # shard q/o on the flat head*hd dim when
    #                                 head count doesn't divide the model axis
    microbatches: int = 1           # gradient-accumulation splits per step
    grad_accum_dtype: str = "float32"  # bf16 halves the accumulator's HBM
    kv_cache_dtype: str = ""        # "" = activation dtype; float8_e4m3fn
    #                                 halves decode cache traffic (§Perf)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------- derived

    @property
    def q_dim(self):
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self):
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self):
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self):
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self):
        return self.n_experts > 0

    @property
    def is_recurrent(self):
        """True if decode state is O(1) in sequence length (no KV cache)."""
        return self.block_kind in ("mamba2", "rwkv6")

    @property
    def sub_quadratic(self):
        """Can this config run long-context decode without a full KV cache?"""
        return (self.is_recurrent or self.block_kind == "hybrid"
                or self.sliding_window > 0 or self.chunked_attention > 0)

    def param_count(self) -> int:
        """Approximate total parameter count (embedding included)."""
        D, F, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        emb = V * D * self.num_codebooks
        head = 0 if self.tie_embeddings else V * D * self.num_codebooks
        per_layer = 0
        if self.block_kind in ("attention", "hybrid"):
            attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
            if self.is_moe:
                mlp = self.n_experts * 3 * D * F + D * self.n_experts
            else:
                mlp = 3 * D * F
            per_layer = attn + mlp
        if self.block_kind in ("mamba2", "hybrid"):
            di, N, H = self.d_inner, self.ssm_state_dim, self.ssm_heads
            mamba = D * (2 * di + 2 * N + H) + di * D + di
            if self.block_kind == "hybrid":
                per_layer = mamba  # hybrid: mamba per layer + shared attn once
            else:
                per_layer = mamba
        if self.block_kind == "rwkv6":
            # time-mix: r,k,v,g,o projections + lora decay + channel-mix
            per_layer = 5 * D * D + 3.5 * D * F // max(F, 1) * F  # approx
            per_layer = int(5 * D * D + 2 * D * F)
        total = emb + head + L * per_layer
        if self.block_kind == "hybrid" and self.hybrid_attn_every:
            shared_attn = (D * self.q_dim + 2 * D * self.kv_dim
                           + self.q_dim * D + 3 * D * F)
            total += shared_attn
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: selected experts only)."""
        if not self.is_moe:
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        dense = self.param_count() - L * self.n_experts * 3 * D * F
        return int(dense + L * self.n_experts_per_token * 3 * D * F)
