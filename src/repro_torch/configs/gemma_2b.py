"""gemma-2b [dense]: GeGLU, head_dim 256, one KV head, a 256k vocab.

18 layers, d_model=2048, 8 heads (MQA, 1 KV head), head_dim 256,
d_ff=16384 (GeGLU), vocab 256000, tied embeddings; the token embeddings
are scaled by sqrt(d_model) (``embed_scale``, which the reference keys on the
name). The same configuration as ``repro.configs.gemma_2b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=256_000,
    head_dim=256,
    activation="gelu",  # GeGLU
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10_000.0,
    grad_accum=2,
)
