"""llama3-8b [dense]: GQA, a 128k vocab.

32 layers, d_model=4096, 32 heads (GQA, 8 KV heads), d_ff=14336 (SwiGLU),
vocab 128256, untied embeddings. The same configuration as
``repro.configs.llama3_8b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    activation="silu",  # SwiGLU
    rope_theta=500_000.0,
)
