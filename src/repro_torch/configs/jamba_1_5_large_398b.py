"""jamba-1.5-large-398b [hybrid]: Mamba and attention interleaved 7:1, MoE.

[arXiv:2403.19887] 72 layers, d_model=8192, 64 heads (GQA, 8 KV heads),
d_ff=24576, vocab 65536, 16 experts top-2 on every other layer. Every
Mamba block holds a causal depthwise conv1d (K=4), the paper's sliding
window. The same configuration as ``repro.configs.jamba_1_5_large_398b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,  # per-expert FFN width
    vocab_size=65_536,
    activation="silu",
    num_experts=16,
    experts_per_token=2,
    moe_every=2,  # MoE on every other layer
    attn_every=8,  # 1 attention : 7 mamba
    mamba_d_state=16,
    mamba_conv_k=4,
    mamba_expand=2,
    rope_theta=10_000.0,
    opt_state_dtype="int8",
    grad_accum=16,
    grad_accum_dtype="bfloat16",
)
