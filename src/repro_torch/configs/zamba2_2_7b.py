"""Zamba2-2.7B  [arXiv:2411.15242]

Hybrid: 54 Mamba2 layers with a *shared* attention(+MLP) block applied every
`hybrid_attn_every` layers (single weight copy, multiple call sites).  SSM
state 64, natively sub-quadratic decode; the shared attention uses a sliding
window for the long_500k shape."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    block_kind="hybrid",
    ssm_state_dim=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_attn_every=9,   # 6 shared-attention call sites over 54 layers
    rope_theta=1e4,
    citation="arXiv:2411.15242",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512, hybrid_attn_every=1, ssm_state_dim=32,
        dtype="float32", remat=False)
