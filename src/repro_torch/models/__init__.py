"""Model registry: family -> implementation."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import Runtime


def build_model(cfg: ModelConfig, rt: Runtime | None = None):
    """The family's model; ``rt`` (one rank when None) carries the mesh."""
    if cfg.family in ("dense", "moe"):
        from repro_torch.models.transformer import DenseLM

        return DenseLM(cfg, rt)
    if cfg.family == "vlm":
        from repro_torch.models.llava import Llava

        return Llava(cfg, rt)
    if cfg.family == "audio":
        from repro_torch.models.whisper import Whisper

        return Whisper(cfg, rt)
    if cfg.family == "ssm":
        from repro_torch.models.rwkv6 import RWKV6

        return RWKV6(cfg, rt, wkv_mode=cfg.rwkv_wkv_mode)
    if cfg.family == "hybrid":
        from repro_torch.models.jamba import Jamba

        return Jamba(cfg, rt)
    raise ValueError(f"unknown family {cfg.family!r}")
