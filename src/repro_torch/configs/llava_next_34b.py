"""llava-next-34b [vlm]: anyres tiling; the transformer backbone only.

60 layers, d_model=7168, 56 heads (GQA, 8 KV heads), d_ff=20480, vocab
64000. The vision tower is a stub: requests carry precomputed patch
embeddings (B, num_patches, 1152), which the 2-layer projector maps into
the LM's embedding space. The non-stub patch embedding (conv2d k=14 s=14)
is ``repro_torch.models.llava.patch_embed``, on the 2-D sliding conv
kernel. The same configuration as ``repro.configs.llava_next_34b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64_000,
    activation="silu",
    frontend="vision_stub",
    num_patches=2880,  # anyres: 5 tiles x 576 patches
    rope_theta=1_000_000.0,
    grad_accum=8,
)
