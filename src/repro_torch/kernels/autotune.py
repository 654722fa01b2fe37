"""Shape keys, the same strings as ``repro.kernels.autotune`` so dispatch
logs of the two packages line up. No tuning cache is ported yet."""
from __future__ import annotations


def conv2d_key(B, H, W, Cin, Cout, kh, kw, sh, sw, dtype,
               grad: bool = False) -> str:
    """conv2d shape key; ``grad=True`` keys the backward entry."""
    base = (f"conv2d|B{B}|H{H}|W{W}|Cin{Cin}|Cout{Cout}"
            f"|K{kh}x{kw}|s{sh}x{sw}|{dtype}")
    return base + "|grad" if grad else base


def conv1d_dw_key(B, L, C, K, stride, dtype) -> str:
    """Depthwise conv1d shape key (the mamba conv path; ``dtype`` is the
    precision name for the quantized kernel, e.g. "w8a8")."""
    return f"conv1ddw|B{B}|L{L}|C{C}|K{K}|s{stride}|{dtype}"


def attn_dec_key(B, S, KV, G, D, kind) -> str:
    """Fused decode-attention shape key (``ops.attention_decode``). ``kind``
    is "int8" for the quantized cache, else the float cache dtype name."""
    return f"attn_dec|B{B}|S{S}|KV{KV}|G{G}|D{D}|{kind}"


def pool1d_key(B, L, C, window, op, dtype) -> str:
    """Sliding-pool shape key (``ops.pool1d``); the reference's tuned entry
    under it selects the max-pool evaluation (``scan`` or ``shift``)."""
    return f"pool1d|B{B}|L{L}|C{C}|w{window}|{op}|{dtype}"
