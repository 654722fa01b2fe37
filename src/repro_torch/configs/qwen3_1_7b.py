"""qwen3-1.7b [dense]: qk_norm, GQA, a 152k vocab, tied embeddings.

28 layers, d_model=2048, 16 heads (GQA, 8 KV heads), head_dim 128,
d_ff=6144, vocab 151936. The same configuration as
``repro.configs.qwen3_1_7b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151_936,
    head_dim=128,
    activation="silu",
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
