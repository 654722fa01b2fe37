"""LLaVA-NeXT backbone: the dense LM with a patch-embedding prefix
(``repro.models.llava``).

The vision tower is a stub: a request carries precomputed patch
embeddings (B, num_patches, 1152), from the anyres-tiled images, which the
projector maps into the LM's embedding space (``DenseLM.embeds_for``).
``patch_embed`` is the non-stub patch embedding, a conv2d with k=14 and
s=14 over image tiles through the paper's sliding conv2d: on
``backend="sliding_pallas"`` one launch of the 2-D sliding conv kernel,
with the optional bias fused into its epilogue, differentiable through
``ops.Conv2dSliding``; with an int8 weight one launch of the int8 conv2d
kernel.

On a mesh the backbone takes ``DenseLM``'s layout, and under
``FSDP_RULES`` the projector's ``embed`` blocks are gathered with the
other leaves outside the blocks before the patches are projected. The
patch embedding's weight is the caller's, not a leaf of the model's tree
(the vision tower is a stub), so the rules split nothing of it: a caller
hands ``patch_embed`` the whole weight, and row 4 launches on it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import Runtime
from repro_torch.models.layers import conv2d_bias_act
from repro_torch.models.transformer import VISION_DIM, DenseLM

__all__ = ["PATCH", "VISION_DIM", "Llava", "patch_embed"]

PATCH = 14


def patch_embed(w: torch.Tensor, images: torch.Tensor, backend: str = "sliding",
                bias: torch.Tensor | None = None,
                precision: str = "fp") -> torch.Tensor:
    """images: (B, H, W, 3) -> (B, (H // 14) * (W // 14), VISION_DIM).

    conv2d k=14 s=14 is a non-overlapping sliding window; w: (14, 14, 3,
    VISION_DIM), or a ``quant.QuantizedWeight`` (and/or ``precision``
    "w8a8" / "w8a16") for int8 inference. A weight whose ``out_scale`` is
    the projector's input scale emits int8 codes for
    ``transformer.projector_apply(..., x_scale=...)``, the chain's one
    dequant."""
    y = conv2d_bias_act(
        images, w, bias, stride=(PATCH, PATCH), padding="VALID",
        backend=backend, precision=precision, site="llava/patch_embed",
    )
    B, h, ww, c = y.shape
    return y.reshape(B, h * ww, c)


class Llava(DenseLM):
    """DenseLM already understands the ``patches`` batch key and the
    projector."""

    def __init__(self, cfg: ModelConfig, rt: Runtime | None = None):
        if cfg.frontend != "vision_stub":
            raise ValueError(f"llava needs frontend 'vision_stub', got "
                             f"{cfg.frontend!r}")
        super().__init__(cfg, rt)
