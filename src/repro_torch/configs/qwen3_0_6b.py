"""Qwen3-0.6B  [hf:Qwen/Qwen3-8B family card]

Small dense decoder with qk-norm and GQA; tied embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
    citation="hf:Qwen/Qwen3-8B",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, dtype="float32", remat=False)
