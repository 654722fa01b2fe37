"""whisper-medium [audio]: encoder-decoder with a two-conv frontend.

[arXiv:2212.04356] 24+24 layers, d_model=1024, 16 heads (MHA), d_ff=4096,
vocab 51865. The same configuration as ``repro.configs.whisper_medium``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,  # decoder depth
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    activation="gelu_plain",  # whisper MLP is plain GELU (not gated)
    cross_attention=True,
    frontend="audio_stub",
    rope_theta=10_000.0,
)
