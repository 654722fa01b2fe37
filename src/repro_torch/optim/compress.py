"""int8 per-row quantization (``repro.optim.compress``).

``quantize_int8`` / ``dequantize_int8``: absmax over the last axis, the
scale ``max |x| / 127 + 1e-12`` in float32, codes ``round(x / s)`` (half to
even) with no clip. The int8 KV cache quantizes through it
(``models.common.quantize_kv_leaf``). Not ported yet: the error-feedback
compressed gradient all-reduce (``ef_allreduce_grads``) and int8 optimizer
moments.
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per last-axis-row absmax quantization: (q int8, scale float32 with
    the last axis kept as 1)."""
    xf = x.float()
    if x.dim() == 0:
        s = xf.abs() / 127.0 + 1e-12
        return torch.round(xf / s).to(torch.int8), s
    s = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    return torch.round(xf / s).to(torch.int8), s


def dequantize_int8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s
