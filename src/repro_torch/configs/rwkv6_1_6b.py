"""rwkv6-1.6b [ssm]: Finch, attention-free, with data-dependent decay.

24 layers, d_model=2048 (32 heads of 64 in the time mix), d_ff=7168
(squared-relu channel mix), vocab 65536, untied embeddings. The WKV
recurrence is evaluated chunkwise (128 positions a chunk). The same
configuration as ``repro.configs.rwkv6_1_6b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=0,  # attention-free
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65_536,
    rwkv_head_dim=64,
    activation="relu_sq",
    rwkv_wkv_mode="chunked",
    rwkv_wkv_chunk=128,
)
