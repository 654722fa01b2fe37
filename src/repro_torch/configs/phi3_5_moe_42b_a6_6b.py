"""phi3.5-moe-42b-a6.6b [moe]: 16 experts, top-2.

32 layers, d_model=4096, 32 heads (GQA, 8 KV heads), an expert FFN of
d_ff=6400 (SwiGLU) in every layer, 16 experts with 2 active a token, vocab
32064, untied embeddings. The same configuration as
``repro.configs.phi3_5_moe_42b_a6_6b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,  # per-expert FFN width
    vocab_size=32_064,
    activation="silu",
    num_experts=16,
    experts_per_token=2,
    rope_theta=10_000.0,
    grad_accum=4,
)
