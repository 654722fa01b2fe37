"""Quantization primitives and the plain quantized sliding conv1d
(``repro.quant.qconv``).

  * ``QuantizedWeight``: the params leaf ``quant.apply`` swaps in: int8
    codes in the layout of the float weight, a float32 (Cout,) scale, and
    the calibrated activation scales of the weight's conv site.
  * ``quantize_weight`` / ``act_scale`` / ``quantize_act``: symmetric
    absmax int8 quantizers, per output channel for weights and per tensor
    for activations (a per-channel activation scale would not commute with
    the conv's Cin reduction). Codes are ``round(x / s)``, half to even,
    clipped to +-127; every scale is float32 with ``+ 1e-12``.
  * ``conv1d_q``: the quantized sliding conv1d in plain torch.
    ``accumulate="int32"`` is exact: int8 products summed in int32 on the
    CPU and in float64 on the card (which has no integer matrix product;
    float64 holds every sum of this size exactly), then the float32
    epilogue. It is the plain version of the w8a8 kernel. ``"fast"`` sums
    in float32, exact only while |acc| < 2**24 (the layers' path off the
    kernel backend, as in the reference).

  * ``conv2d_q``: the quantized sliding conv2d in plain torch, one matrix
    product per chunk of up to ``TAP_STACK`` taps of a filter row, summed
    as ``conv1d_q`` sums (``"int32"`` exact, the plain version of the int8
    conv2d kernel; ``"fast"`` in float32).
  * ``conv1d_depthwise_q``: the quantized depthwise conv1d (mamba's conv)
    in plain torch, the weight scale per channel over the tap axis.
    ``accumulate="int32"`` sums the int8 products exactly in int32 (on the
    card too: elementwise products need no matrix unit); ``"fast"`` in
    float32. It is the plain version of the int8 depthwise kernel.
  * ``conv2d_q_im2col``: the int8 im2col baseline: the (B, oh·ow,
    kh·kw·Cin) int8 column tensor is built, then one dequantized product.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.conv import _pad_2d, _resolve_pad_1d, _resolve_pad_2d
from repro_torch.kernels.sliding_conv1d import apply_activation


class QuantizedWeight(NamedTuple):
    """int8 conv weight and its scales. ``q``: int8 codes, layout of the
    float weight; ``scale``: float32 (Cout,) absmax/127 per output channel;
    ``x_scale``: the calibrated per-tensor input scale of the weight's conv
    site (None: dynamic absmax at call time); ``out_scale``: set when the
    site's output feeds another quantized conv (requant chaining), the
    consumer's input scale, on whose grid the conv then emits int8."""

    q: torch.Tensor
    scale: torch.Tensor
    x_scale: torch.Tensor | None = None
    out_scale: torch.Tensor | None = None

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)

    def to(self, *args, **kw) -> "QuantizedWeight":
        """Every tensor field moved by ``Tensor.to(*args, **kw)``, dtypes
        kept (a device move)."""
        return QuantizedWeight(*(None if t is None else t.to(*args, **kw)
                                 for t in self))


def quantize_weight(w: torch.Tensor, x_scale=None,
                    out_scale=None) -> QuantizedWeight:
    """Symmetric per-output-channel (last axis) absmax int8 quantization."""
    wf = w.float()
    red = tuple(range(w.dim() - 1))
    s = wf.abs().amax(dim=red) / 127.0 + 1e-12
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return QuantizedWeight(q, s, x_scale, out_scale)


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """Dynamic per-tensor absmax activation scale (float32 scalar)."""
    return x.float().abs().amax() / 127.0 + 1e-12


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """Quantize activations onto a per-tensor int8 grid."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


# taps of one filter row stacked into one matrix product (the reference's
# TAP_STACK): in "fast" mode above 3x3 taps, always in "int32" mode
TAP_STACK = 8


def _epilogue(acc_f32, bias, activation, out_scale, out_dtype):
    """bias, activation, then the optional requant to int8, in float32:
    the kernels' epilogue."""
    if bias is not None:
        acc_f32 = acc_f32 + bias.float()
    y = apply_activation(acc_f32, activation)
    if out_scale is not None:
        return torch.clamp(torch.round(y / out_scale), -127, 127).to(torch.int8)
    return y.to(out_dtype)


def _as_scale(s, device) -> torch.Tensor:
    return torch.as_tensor(s, dtype=torch.float32, device=device).reshape(())


def _resolve_in(x, qw: QuantizedWeight, mode: str, x_scale):
    """(x as the product's operand, per-Cout dequant scale) for a mode."""
    if mode == "w8a8":
        if x.dtype != torch.int8:
            if x_scale is None:
                x_scale = qw.x_scale if qw.x_scale is not None else act_scale(x)
            x = quantize_act(x, x_scale)
        elif x_scale is None:
            raise ValueError("int8 input needs its x_scale")
        return x, qw.scale * _as_scale(x_scale, x.device)
    if mode == "w8a16":
        return x, qw.scale
    raise ValueError(f"unknown quant mode {mode!r}")


def conv1d_q(
    x: torch.Tensor,
    qw: QuantizedWeight,
    bias: torch.Tensor | None = None,
    *,
    mode: str = "w8a8",
    x_scale=None,
    out_scale=None,
    stride: int = 1,
    padding="VALID",
    activation: str = "none",
    accumulate: str = "int32",
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Quantized sliding conv1d. x: (B, L, Cin) float (or int8 codes in
    w8a8, with ``x_scale``); qw.q: (K, Cin, Cout). An int8 input pads with
    code 0. One shifted matrix product per tap."""
    K = qw.q.shape[0]
    lo, hi = _resolve_pad_1d(padding, K, 1)
    if lo or hi:
        x = F.pad(x, (0, 0, lo, hi))
    x, dq = _resolve_in(x, qw, mode, x_scale)
    adt = _acc_dtype(x, mode == "w8a8" and accumulate == "int32")
    xm, wm = x.to(adt), qw.q.to(adt)
    out_len = (x.shape[1] - K) // stride + 1
    if out_len < 1:
        raise ValueError(f"filter K={K} (stride {stride}) exceeds input "
                         f"length {x.shape[1]}")
    span = (out_len - 1) * stride + 1
    acc = None
    for k in range(K):
        t = xm[:, k : k + span : stride] @ wm[k]
        acc = t if acc is None else acc + t
    if out_scale is not None:
        out_scale = _as_scale(out_scale, x.device)
    return _epilogue(acc.float() * dq, bias, activation, out_scale, out_dtype)


def _acc_dtype(x: torch.Tensor, exact: bool) -> torch.dtype:
    """Exact int8 sums: int32 on the CPU, float64 on the card (which has no
    integer matrix product; float64 holds every such sum exactly);
    otherwise float32."""
    if not exact:
        return torch.float32
    return torch.int32 if x.device.type == "cpu" else torch.float64


def conv2d_q(
    x: torch.Tensor,
    qw: QuantizedWeight,
    bias: torch.Tensor | None = None,
    *,
    mode: str = "w8a8",
    x_scale=None,
    out_scale=None,
    stride: tuple[int, int] = (1, 1),
    padding="VALID",
    activation: str = "none",
    accumulate: str = "int32",
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Quantized sliding conv2d. x: (B, H, W, Cin) float (or int8 codes in
    w8a8, with ``x_scale``); qw.q: (kh, kw, Cin, Cout). An int8 input pads
    with code 0. Filter row by filter row, the shifted views of up to
    ``TAP_STACK`` taps concatenated over channels and contracted in one
    matrix product (per tap in "fast" mode at 3x3 taps and below)."""
    kh, kw, _, cout = qw.q.shape
    x = _pad_2d(x, _resolve_pad_2d(padding, kh, kw, (1, 1)))
    x, dq = _resolve_in(x, qw, mode, x_scale)
    exact = mode == "w8a8" and accumulate == "int32"
    stack = TAP_STACK if (exact or kh * kw > 9) else 1
    adt = _acc_dtype(x, exact)
    B, H, W, cin = x.shape
    sh, sw = stride
    oh, ow = (H - kh) // sh + 1, (W - kw) // sw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"filter ({kh},{kw}) (stride {tuple(stride)}) "
                         f"exceeds input ({H},{W})")
    span_h, span_w = (oh - 1) * sh + 1, (ow - 1) * sw + 1
    xm, wm = x.to(adt), qw.q.to(adt)
    acc = None
    for i in range(kh):
        for j0 in range(0, kw, stack):
            j1 = min(j0 + stack, kw)
            cols = [xm[:, i : i + span_h : sh, j : j + span_w : sw]
                    for j in range(j0, j1)]
            col = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
            t = col @ wm[i, j0:j1].reshape((j1 - j0) * cin, cout)
            acc = t if acc is None else acc + t
    if out_scale is not None:
        out_scale = _as_scale(out_scale, x.device)
    return _epilogue(acc.float() * dq, bias, activation, out_scale, out_dtype)


def conv1d_depthwise_q(
    x: torch.Tensor,
    qw: QuantizedWeight,
    bias: torch.Tensor | None = None,
    *,
    mode: str = "w8a8",
    x_scale=None,
    out_scale=None,
    stride: int = 1,
    padding="CAUSAL",
    activation: str = "none",
    accumulate: str = "int32",
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Quantized depthwise sliding conv1d. x: (B, L, C) float (or int8 codes
    in w8a8, with ``x_scale``); qw.q: (K, C) with its per-channel scale
    over the tap axis, (1, C) or (C,) (``apply.quantize_depthwise_weight``).
    One shifted elementwise product per tap, summed in tap order: int32
    when exact, else float32."""
    K = qw.q.shape[0]
    lo, hi = _resolve_pad_1d(padding, K, 1)
    if lo or hi:
        x = F.pad(x, (0, 0, lo, hi))
    wsc = qw.scale.float().reshape(1, -1)
    if mode == "w8a8":
        if x.dtype != torch.int8:
            if x_scale is None:
                x_scale = qw.x_scale if qw.x_scale is not None else act_scale(x)
            x = quantize_act(x, x_scale)
        elif x_scale is None:
            raise ValueError("int8 input needs its x_scale")
        dq = wsc * _as_scale(x_scale, x.device)
    elif mode == "w8a16":
        dq = wsc
    else:
        raise ValueError(f"unknown quant mode {mode!r}")
    adt = torch.int32 if mode == "w8a8" and accumulate == "int32" else torch.float32
    xm, wm = x.to(adt), qw.q.to(adt)
    out_len = (x.shape[1] - K) // stride + 1
    if out_len < 1:
        raise ValueError(f"filter K={K} (stride {stride}) exceeds input "
                         f"length {x.shape[1]}")
    span = (out_len - 1) * stride + 1
    acc = None
    for k in range(K):
        t = xm[:, k : k + span : stride] * wm[k]
        acc = t if acc is None else acc + t
    if out_scale is not None:
        out_scale = _as_scale(out_scale, x.device)
    return _epilogue(acc.float() * dq, bias, activation, out_scale, out_dtype)


def conv2d_q_im2col(
    x: torch.Tensor,
    qw: QuantizedWeight,
    *,
    x_scale=None,
    stride: tuple[int, int] = (1, 1),
    accumulate: str = "fast",
    out_dtype=torch.float32,
) -> torch.Tensor:
    """int8 im2col baseline on a VALID input: the (B, oh·ow, kh·kw·Cin)
    int8 column tensor is built (the kh·kw-fold copy the sliding conv
    avoids), then one product, dequantized by ``w_scale · x_scale``. No
    bias or activation. An int8 input needs its ``x_scale``; a float one
    is quantized onto ``x_scale`` (dynamic absmax when None)."""
    kh, kw, cin, cout = qw.q.shape
    sh, sw = stride
    if x.dtype == torch.int8:
        if x_scale is None:  # the absmax of int8 codes is not a scale
            raise ValueError("int8 input needs its x_scale")
        xq, sx = x, x_scale
    else:
        sx = act_scale(x) if x_scale is None else x_scale
        xq = quantize_act(x, sx)
    B, H, W, _ = xq.shape
    oh, ow = (H - kh) // sh + 1, (W - kw) // sw + 1
    span_h, span_w = (oh - 1) * sh + 1, (ow - 1) * sw + 1
    col = torch.cat([xq[:, i : i + span_h : sh, j : j + span_w : sw]
                     for i in range(kh) for j in range(kw)], dim=-1)
    adt = _acc_dtype(xq, accumulate == "int32")
    y = col.reshape(B, oh * ow, kh * kw * cin).to(adt) @ qw.q.reshape(
        kh * kw * cin, cout).to(adt)
    dq = qw.scale * _as_scale(sx, xq.device)
    return (y.float() * dq).reshape(B, oh, ow, cout).to(out_dtype)
