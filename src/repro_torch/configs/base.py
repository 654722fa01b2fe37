"""Model configuration: ``ModelConfig``, ``smoke_config`` and ``get_config``.

A copy of ``repro.configs.base`` with the same field names and defaults, so
one configuration describes the same model in both packages, and one field
of the port's own: ``embed_scale``, which the reference derives from the
config's name. ``get_config`` resolves every architecture of the
reference's registry.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    # transformer backbone
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # defaults to d_model // num_heads
    activation: str = "silu"  # "silu" (SwiGLU) | "gelu" (GeGLU)
    qk_norm: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False  # token embeddings times sqrt(d_model) (gemma)
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1
    capacity_factor: float = 1.25
    # hybrid (jamba)
    attn_every: int = 0
    mamba_d_state: int = 16
    mamba_conv_k: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int | None = None
    # rwkv6
    rwkv_head_dim: int = 64
    rwkv_wkv_mode: str = "scan"
    rwkv_wkv_chunk: int = 32
    # multimodal / enc-dec
    frontend: str | None = None  # "vision_stub" | "audio_stub"
    encoder_layers: int = 0  # whisper: encoder depth (num_layers = decoder)
    cross_attention: bool = False
    num_patches: int = 1024
    # numerics & technique
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    conv_backend: str = "sliding"  # the paper's technique toggle
    conv_precision: str = "fp"
    kv_quant: str = "fp"
    attn_decode: str = "fused"  # "fused" (decode kernel) | "view"
    eos_id: int = 1
    remat: str = "block"
    attn_chunk: int = 1024  # flash-style KV/Q chunking threshold & size
    loss_chunk: int = 512
    opt_state_dtype: str = "float32"
    scan_layers: bool = True
    grad_accum: int = 1
    grad_accum_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# architectures this package serves: the reference's whole registry
PORTED_ARCHS = {
    "whisper-medium": "whisper_medium",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llava-next-34b": "llava_next_34b",
    "qwen3-1.7b": "qwen3_1_7b",
    "llama3-8b": "llama3_8b",
    "gemma-2b": "gemma_2b",
    "granite-8b": "granite_8b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}


def get_config(name: str) -> ModelConfig:
    if name not in PORTED_ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(PORTED_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{PORTED_ARCHS[name]}")
    return mod.CONFIG


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (the reference's
    ``smoke_config``, field for field)."""
    kw: dict[str, Any] = dict(
        num_layers=min(cfg.num_layers, 2 if cfg.attn_every == 0 else cfg.attn_every),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads > 1 else 1,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        param_dtype="float32",
        compute_dtype="float32",
        attn_chunk=64,
        loss_chunk=64,
        scan_layers=cfg.scan_layers,
        opt_state_dtype="float32",
    )
    if cfg.num_experts:
        kw.update(num_experts=4, experts_per_token=2)
    if cfg.attn_every:
        kw.update(attn_every=cfg.attn_every, num_layers=cfg.attn_every)
        kw.update(mamba_d_state=8)
    if cfg.family == "ssm":
        kw.update(rwkv_head_dim=32)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2)
    if cfg.family == "vlm":
        kw.update(num_patches=16)
    return cfg.replace(**kw)
