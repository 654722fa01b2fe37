"""Kernel dispatch: the layer-facing entry points of the kernels.

The floating-point forward subset of ``repro.kernels.ops``:

  * ``conv1d``: padding outside the kernel, then the backend. ``sliding``
    is the plain tap loop of ``core.conv`` with an unfused epilogue;
    ``sliding_pallas`` (the reference's name, kept so one command line
    drives both packages) is the fused CUDA kernel; ``xla`` is
    ``torch.nn.functional.conv1d`` with an unfused epilogue.
  * ``attention_decode``: the decode-attention kernel, with a dispatch log
    keyed like the reference's ``ATTN_DECODE_DISPATCH``.

The reference demotes a failing Pallas kernel down a ladder of compiled
twins. There is no ladder here: a CUDA tensor goes to the kernel or the
call raises, and the plain versions serve only CPU tensors.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from repro_torch.core import conv as core_conv
from repro_torch.kernels import attention_decode as attn_dec
from repro_torch.kernels import autotune, sliding_conv1d
from repro_torch.kernels.sliding_conv1d import apply_activation

CONV_BACKENDS = ("sliding", "sliding_pallas", "xla")


class DispatchLog:
    """Dedup-counted dispatch log: ``key → (last value, hit count)``, so a
    long serving run grows state only per distinct shape key."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: dict[str, list] = {}

    def __setitem__(self, key: str, value) -> None:
        with self._lock:
            ent = self._entries.setdefault(key, [value, 0])
            ent[0] = value
            ent[1] += 1

    def count(self, key: str) -> int:
        ent = self._entries.get(key)
        return 0 if ent is None else ent[1]

    def items(self):
        return [(k, v[0]) for k, v in self._entries.items()]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


ATTN_DECODE_DISPATCH = DispatchLog()


def _pad1d(x, padding, k, dilation=1):
    lo, hi = core_conv._resolve_pad_1d(padding, k, dilation)
    if lo or hi:
        x = F.pad(x, (0, 0, lo, hi))
    return x


def epilogue_unfused(y, bias, activation):
    """bias + activation outside the kernel (the non-kernel backends), with
    the fused epilogue's numerics: both in float32, one cast back."""
    if bias is None and activation in (None, "none"):
        return y
    yf = y.float()
    if bias is not None:
        yf = yf + bias.float()
    return apply_activation(yf, activation).to(y.dtype)


def conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding="VALID",
    backend: str = "sliding_pallas",
    bias: torch.Tensor | None = None,
    activation: str = "none",
) -> torch.Tensor:
    """Multi-channel 1-D convolution + bias + activation. x: (B, L, Cin),
    w: (K, Cin, Cout); padding VALID / SAME / CAUSAL / (lo, hi)."""
    if backend == "xla":
        lo, hi = core_conv._resolve_pad_1d(padding, w.shape[0], 1)
        y = F.conv1d(
            F.pad(x, (0, 0, lo, hi)).transpose(1, 2), w.permute(2, 1, 0),
            stride=stride,
        ).transpose(1, 2).to(x.dtype)
        return epilogue_unfused(y, bias, activation)
    x = _pad1d(x, padding, w.shape[0])
    if backend == "sliding_pallas":
        return sliding_conv1d.conv1d_sliding(
            x, w, bias, stride=stride, activation=activation
        )
    if backend == "sliding":
        y = core_conv.conv1d_sliding(x, w, stride=stride, padding="VALID")
        return epilogue_unfused(y, bias, activation)
    raise ValueError(f"unknown conv backend {backend!r}; one of {CONV_BACKENDS}")


def attention_decode(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """Fused decode attention against the fp KV cache. q: (B, H, D) the new
    token's query heads; k/v: (B, S, KV, D); lengths: (B,) int32 valid
    prefix per slot (decode: pos + 1; cross-attention: encoder lengths; 0
    gives a zero row). GQA: H = KV * G. Returns (B, H, D) float32."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"H={H} not divisible by KV={KV}")
    G = H // KV
    kind = str(k.dtype).removeprefix("torch.")
    key = autotune.attn_dec_key(B, S, KV, G, D, kind)
    ATTN_DECODE_DISPATCH[key] = "cuda" if q.device.type == "cuda" else "plain"
    out = attn_dec.decode_attention(q.reshape(B, KV, G, D), k, v, lengths)
    return out.reshape(B, H, D)
