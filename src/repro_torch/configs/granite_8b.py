"""granite-8b [dense]: the llama architecture, a code model, a 49k vocab.

36 layers, d_model=4096, 32 heads (GQA, 8 KV heads), d_ff=14336 (SwiGLU),
vocab 49152, tied embeddings. The same configuration as
``repro.configs.granite_8b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49_152,
    activation="silu",
    tie_embeddings=True,  # granite code ties its embeddings
    rope_theta=10_000_000.0,
)
