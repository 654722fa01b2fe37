"""Convolution by sliding-window evaluation, in plain torch.

The ``sliding`` backend of ``repro.core.conv``: every filter tap adds one
(Cin × Cout) matrix product over a shifted slice of the unmodified input,
so no im2col buffer is built. Layout NLC (batch, length, channels);
weights (K, Cin, Cout), or (K, C) for the depthwise conv, where each tap is
one shifted elementwise multiply-add. This is the backend that runs when the model asks
for ``conv_backend="sliding"``; the CUDA kernel is reached through
``repro_torch.kernels.ops.conv1d`` (``sliding_pallas``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# the paper's kernel regimes by filter width (see ``regime_for``)
CUSTOM_TAPS = (3, 5)
GENERIC_MAX_TAP = 17


def regime_for(k: int) -> str:
    """Paper's kernel-regime selection by filter width."""
    if k in CUSTOM_TAPS:
        return "custom"
    if k <= GENERIC_MAX_TAP:
        return "generic"
    return "compound"


def _resolve_pad_1d(padding, k: int, dilation: int) -> tuple[int, int]:
    eff = (k - 1) * dilation + 1
    if padding == "VALID":
        return (0, 0)
    if padding == "SAME":
        total = eff - 1
        return (total // 2, total - total // 2)
    if padding == "CAUSAL":
        return (eff - 1, 0)
    lo, hi = padding
    return (int(lo), int(hi))


def _out_len(n: int, k: int, stride: int, dilation: int, lo: int, hi: int) -> int:
    eff = (k - 1) * dilation + 1
    return (n + lo + hi - eff) // stride + 1


def conv1d_sliding(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding="VALID",
    dilation: int = 1,
) -> torch.Tensor:
    """Sliding-window 1-D convolution. x: (B, L, Cin), w: (K, Cin, Cout).

    y[b, i, co] = sum_k sum_ci w[k, ci, co] * x[b, i*stride + k*dilation, ci]

    Accumulates in float32 (or wider) and casts back to ``x.dtype``.
    """
    B, L, Cin = x.shape
    K, Cin_w, Cout = w.shape
    if Cin_w != Cin:
        raise ValueError(f"w has Cin={Cin_w}, x has {Cin}")
    lo, hi = _resolve_pad_1d(padding, K, dilation)
    if lo or hi:
        x = F.pad(x, (0, 0, lo, hi))
    out_len = _out_len(L, K, stride, dilation, lo, hi)
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xa, wa = x.to(acc_dtype), w.to(acc_dtype)
    acc = torch.zeros((B, out_len, Cout), dtype=acc_dtype, device=x.device)
    span = (out_len - 1) * stride + 1
    for k in range(K):  # unrolled tap loop: one shifted matmul per tap
        xs = xa[:, k * dilation : k * dilation + span : stride]
        acc = acc + xs @ wa[k]
    return acc.to(x.dtype)


def conv1d_depthwise_sliding(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    padding="CAUSAL",
    stride: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """Depthwise sliding conv1d. x: (B, L, C), w: (K, C).

    y[b, i, c] = sum_k w[k, c] * x[b, i*stride + k*dilation, c]

    Every tap is one shifted elementwise multiply-add over the whole
    input (the paper's vector slide); the sum runs in float32 (or wider)
    and is cast back to ``x.dtype``.
    """
    B, L, C = x.shape
    K, Cw = w.shape
    if Cw != C:
        raise ValueError(f"channel mismatch {Cw} != {C}")
    lo, hi = _resolve_pad_1d(padding, K, dilation)
    if lo or hi:
        x = F.pad(x, (0, 0, lo, hi))
    out_len = _out_len(L, K, stride, dilation, lo, hi)
    span = (out_len - 1) * stride + 1
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    acc = torch.zeros((B, out_len, C), dtype=acc_dtype, device=x.device)
    for k in range(K):
        xs = x[:, k * dilation : k * dilation + span : stride]
        acc = acc + xs.to(acc_dtype) * w[k].to(acc_dtype)
    return acc.to(x.dtype)
