"""qwen3-moe-30b-a3b [moe]: 128 experts, top-8, qk_norm.

48 layers, d_model=2048, 32 heads (GQA, 4 KV heads), head_dim 128, an
expert FFN of d_ff=768 (SwiGLU) in every layer, 128 experts with 8 active
a token, vocab 151936, untied embeddings. The same configuration as
``repro.configs.qwen3_moe_30b_a3b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,  # per-expert FFN width
    vocab_size=151_936,
    head_dim=128,
    activation="silu",
    qk_norm=True,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1_000_000.0,
    grad_accum=4,
)
