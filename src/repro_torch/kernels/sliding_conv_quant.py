"""int8 quantized sliding conv1d, dense and depthwise, with a fused
dequant, bias, activation and optional requant epilogue.

``conv1d_quant`` is the wrapper: on a CUDA tensor it launches the Hopper
kernel ``csrc/sliding_conv_quant.cu``; on a CPU tensor it runs
``conv1d_quant_plain``, the exact ``quant.qconv.conv1d_q`` (int32 sums on
the CPU, float64 on the card). Any other device raises. Nothing falls back
from the kernel to the plain version.

Contract (the TPU kernel's, ``repro.kernels.sliding_conv_quant``): VALID
conv1d on an input the caller already padded. w_q int8 (K, Cin, Cout),
w_scale float32 (Cout,) per output channel, bias (Cout,) or None.

  * ``mode="w8a8"``: x int8 codes on the ``x_scale`` grid; int8 products
    summed exactly in int32; dequant by ``w_scale * x_scale``.
  * ``mode="w8a16"``: x float32 or bfloat16; the weight codes are widened
    to float and summed in float32; dequant by ``w_scale``.

With ``out_scale`` the output is int8, ``clip(round(y / out_scale))``
after the activation (requant); otherwise ``out_dtype``. ``x_scale`` and
``out_scale`` are float32 scalars.

``conv1d_depthwise_quant`` is the depthwise counterpart (the TPU kernel
``conv1d_depthwise_quant_pallas``; CUDA ``csrc/conv1d_depthwise_quant.cu``;
plain version ``conv1d_depthwise_quant_plain``, the exact
``quant.qconv.conv1d_depthwise_q``): w_q int8 (K, C), w_scale float32 per
channel, (C,) or (1, C), bias (C,) or None, the same two modes and the same
epilogue.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.sliding_conv1d import ACTIVATIONS
from repro_torch.quant import qconv

MODES = {"w8a8": 0, "w8a16": 1}
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# x, w, scale, bias, out_scale, y; B, L, Cin, Cout, K, stride, Lout, act,
# mode, x_kind, y_kind; stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
# x, w, scale, bias, out_scale, y; B, L, C, K, stride, Lout, act, mode,
# x_kind, y_kind; stream
_DW_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def _check(x, w_q, w_scale, bias, x_scale, mode, stride, activation,
           out_dtype) -> int:
    if x.dim() != 3 or w_q.dim() != 3 or w_q.shape[1] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w_q.shape)} do not "
                         "form (B, L, Cin) and (K, Cin, Cout)")
    if w_scale.shape != (w_q.shape[2],):
        raise ValueError(f"w_scale {tuple(w_scale.shape)} is not (Cout,)")
    return _check_common(x, w_q, bias, x_scale, mode, stride, activation,
                         out_dtype)


def _check_common(x, w_q, bias, x_scale, mode, stride, activation,
                  out_dtype) -> int:
    """The checks both convs share (w_q's last axis is the output
    channel); returns the output length."""
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    if bias is not None and bias.shape != (w_q.shape[-1],):
        raise ValueError(f"bias {tuple(bias.shape)} is not "
                         f"({w_q.shape[-1]},)")
    if mode == "w8a8":
        if x.dtype != torch.int8 or x_scale is None:
            raise TypeError("w8a8 takes int8 x with its x_scale")
    elif mode == "w8a16":
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"w8a16 takes float32 or bfloat16 x, got {x.dtype}")
    else:
        raise ValueError(f"unknown quant mode {mode!r}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if stride < 1:
        raise ValueError(f"stride {stride} < 1")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    out_len = (x.shape[1] - w_q.shape[0]) // stride + 1
    if out_len < 1:
        raise ValueError(f"filter K={w_q.shape[0]} (stride {stride}) exceeds "
                         f"input length {x.shape[1]}")
    return out_len


def conv1d_quant_plain(
    x, w_q, w_scale, bias=None, *, x_scale=None, out_scale=None,
    mode: str = "w8a8", stride: int = 1, activation: str = "none",
    out_dtype=torch.float32,
):
    """The kernel's function in plain torch: ``qconv.conv1d_q`` with exact
    accumulation (w8a8) on an already padded input."""
    _check(x, w_q, w_scale, bias, x_scale, mode, stride, activation, out_dtype)
    return qconv.conv1d_q(
        x, qconv.QuantizedWeight(w_q, w_scale), bias, mode=mode,
        x_scale=x_scale, out_scale=out_scale, stride=stride, padding="VALID",
        activation=activation, accumulate="int32", out_dtype=out_dtype,
    )


def _epilogue_operands(dev, w_q, w_scale, bias, x_scale, out_scale, mode):
    """Check that every operand lies on ``dev``; return the epilogue's
    float32 operands: the per-channel dequant row (the weight scale times
    the activation scale first, as the reference forms it), the bias and
    the requant scale, each None where absent."""
    for t in (w_q, w_scale, bias, x_scale, out_scale):
        if isinstance(t, torch.Tensor) and t.device != dev:
            raise ValueError("x, weights and scales must lie on one device")
    s = w_scale.float().reshape(-1)
    if mode == "w8a8":
        s = s * torch.as_tensor(x_scale, dtype=torch.float32, device=dev)
    b32 = None if bias is None else bias.float().contiguous()
    os32 = None if out_scale is None else torch.as_tensor(
        out_scale, dtype=torch.float32, device=dev).reshape(1).contiguous()
    return s.contiguous(), b32, os32


def _launch(x, w_q, w_scale, bias, x_scale, out_scale, mode, stride,
            activation, out_dtype, out_len):
    dev = x.device
    s, b32, os32 = _epilogue_operands(dev, w_q, w_scale, bias, x_scale,
                                      out_scale, mode)
    fn = build.entry("sliding_conv_quant", "sliding_conv_quant", _ARGTYPES)
    x, w_q = x.contiguous(), w_q.contiguous()
    cin = x.shape[2]
    if mode == "w8a8" and cin % 4:
        # dp4a sums four channels at a time: pad with zero codes
        pad = 4 - cin % 4
        x = F.pad(x, (0, pad))
        w_q = F.pad(w_q, (0, 0, 0, pad))
    elif mode == "w8a8" and x.data_ptr() % 4:
        x = x.clone()  # word loads need a 4-byte aligned base
    B, L, Cin = x.shape
    K, _, Cout = w_q.shape
    odt = torch.int8 if out_scale is not None else out_dtype
    y = torch.empty((B, out_len, Cout), dtype=odt, device=dev)
    code = fn(
        x.data_ptr(), w_q.data_ptr(), s.data_ptr(),
        None if b32 is None else b32.data_ptr(),
        None if os32 is None else os32.data_ptr(), y.data_ptr(),
        B, L, Cin, Cout, K, stride, out_len, ACTIVATIONS[activation],
        MODES[mode], _KINDS[x.dtype], _KINDS[odt],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check("sliding_conv_quant", code)
    conv1d_quant.launches += 1
    return y


def conv1d_quant(
    x, w_q, w_scale, bias=None, *, x_scale=None, out_scale=None,
    mode: str = "w8a8", stride: int = 1, activation: str = "none",
    out_dtype=torch.float32,
):
    """VALID int8 sliding conv1d + dequant + bias + activation (+ requant):
    the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor.
    ``conv1d_quant.launches`` counts kernel launches."""
    out_len = _check(x, w_q, w_scale, bias, x_scale, mode, stride,
                     activation, out_dtype)
    if x.device.type == "cuda":
        return _launch(x, w_q, w_scale, bias, x_scale, out_scale, mode,
                       stride, activation, out_dtype, out_len)
    if x.device.type == "cpu":
        return conv1d_quant_plain(
            x, w_q, w_scale, bias, x_scale=x_scale, out_scale=out_scale,
            mode=mode, stride=stride, activation=activation,
            out_dtype=out_dtype)
    raise ValueError(f"no sliding_conv_quant for device {x.device}")


conv1d_quant.launches = 0


# ---------------------------------------------------------------------------
# depthwise
# ---------------------------------------------------------------------------

def _check_depthwise(x, w_q, w_scale, bias, x_scale, mode, stride,
                     activation, out_dtype) -> int:
    if x.dim() != 3 or w_q.dim() != 2 or w_q.shape[1] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w_q.shape)} do not "
                         "form (B, L, C) and (K, C)")
    if w_scale.numel() != w_q.shape[1] or w_scale.shape[-1] != w_q.shape[1]:
        raise ValueError(f"w_scale {tuple(w_scale.shape)} is not (C,) or "
                         "(1, C)")
    return _check_common(x, w_q, bias, x_scale, mode, stride, activation,
                         out_dtype)


def conv1d_depthwise_quant_plain(
    x, w_q, w_scale, bias=None, *, x_scale=None, out_scale=None,
    mode: str = "w8a8", stride: int = 1, activation: str = "none",
    out_dtype=torch.float32,
):
    """The depthwise kernel's function in plain torch:
    ``qconv.conv1d_depthwise_q`` with exact accumulation (w8a8) on an
    already padded input."""
    _check_depthwise(x, w_q, w_scale, bias, x_scale, mode, stride,
                     activation, out_dtype)
    return qconv.conv1d_depthwise_q(
        x, qconv.QuantizedWeight(w_q, w_scale), bias, mode=mode,
        x_scale=x_scale, out_scale=out_scale, stride=stride, padding="VALID",
        activation=activation, accumulate="int32", out_dtype=out_dtype,
    )


def _launch_depthwise(x, w_q, w_scale, bias, x_scale, out_scale, mode,
                      stride, activation, out_dtype, out_len):
    dev = x.device
    s, b32, os32 = _epilogue_operands(dev, w_q, w_scale, bias, x_scale,
                                      out_scale, mode)
    fn = build.entry("conv1d_depthwise_quant", "conv1d_depthwise_quant",
                     _DW_ARGTYPES)
    x, w_q = x.contiguous(), w_q.contiguous()
    B, L, C = x.shape
    odt = torch.int8 if out_scale is not None else out_dtype
    y = torch.empty((B, out_len, C), dtype=odt, device=dev)
    code = fn(
        x.data_ptr(), w_q.data_ptr(), s.data_ptr(),
        None if b32 is None else b32.data_ptr(),
        None if os32 is None else os32.data_ptr(), y.data_ptr(),
        B, L, C, w_q.shape[0], stride, out_len, ACTIVATIONS[activation],
        MODES[mode], _KINDS[x.dtype], _KINDS[odt],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check("conv1d_depthwise_quant", code)
    conv1d_depthwise_quant.launches += 1
    return y


def conv1d_depthwise_quant(
    x, w_q, w_scale, bias=None, *, x_scale=None, out_scale=None,
    mode: str = "w8a8", stride: int = 1, activation: str = "none",
    out_dtype=torch.float32,
):
    """VALID int8 depthwise conv1d + dequant + bias + activation (+
    requant): the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor. ``conv1d_depthwise_quant.launches`` counts kernel
    launches."""
    out_len = _check_depthwise(x, w_q, w_scale, bias, x_scale, mode, stride,
                               activation, out_dtype)
    if x.device.type == "cuda":
        return _launch_depthwise(x, w_q, w_scale, bias, x_scale, out_scale,
                                 mode, stride, activation, out_dtype, out_len)
    if x.device.type == "cpu":
        return conv1d_depthwise_quant_plain(
            x, w_q, w_scale, bias, x_scale=x_scale, out_scale=out_scale,
            mode=mode, stride=stride, activation=activation,
            out_dtype=out_dtype)
    raise ValueError(f"no conv1d_depthwise_quant for device {x.device}")


conv1d_depthwise_quant.launches = 0
