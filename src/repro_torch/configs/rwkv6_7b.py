"""RWKV-6 (Finch) 7B  [arXiv:2404.05892]

Attention-free linear RNN with data-dependent per-channel decay; O(1) decode
state (token-shift + per-head wkv matrix), natively sub-quadratic, so it runs
the long_500k shape with no KV cache at all."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # wkv heads = d_model / ssm_head_dim
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    block_kind="rwkv6",
    ssm_head_dim=64,
    citation="arXiv:2404.05892",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512, dtype="float32", remat=False)
