from repro_torch.configs.base import (
    PORTED_ARCHS,
    ModelConfig,
    get_config,
    smoke_config,
)

__all__ = ["PORTED_ARCHS", "ModelConfig", "get_config", "smoke_config"]
