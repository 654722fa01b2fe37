"""PyTorch/CUDA port of the sliding-window convolution system.

The JAX package ``repro`` is the reference; this package mirrors its layout
module for module and imports nothing from it. Hand-written Hopper kernels
live under ``repro_torch/kernels/csrc`` and are built at first use
(``repro_torch.kernels.build``).

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU (``device="cpu"``, as the CPU tests do). With no card present and no
explicit CPU request they raise: nothing carries on silently on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise. Raises when the card is asked for (explicitly or by
    default) and none is present. On the card, float32 matrix products and
    convolutions are pinned to full float32: the JAX reference does not
    compute in TF32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
