"""int8 quantized sliding conv1d, dense and depthwise, with a fused
dequant, bias, activation and optional requant epilogue.

``conv1d_quant`` is the wrapper: on a CUDA tensor it launches the Hopper
kernel ``csrc/sliding_conv_quant.cu``, the conv as one product on
``csrc/gemm_mma.cuh``'s main loop as for the fp conv1d (w8a8 on its int8
tensor-core tile, w8a16 on the fp conv's tiles with the codes widened),
with the tile, the split of the taps and the copy widths from
``gemm_plan`` and the card's SM count
(``sliding_conv1d.conv1d_launch``); on a CPU tensor it runs
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

``conv2d_quant`` is the 2-D counterpart (the TPU kernel
``conv2d_quant_pallas``; CUDA ``csrc/sliding_conv2d_quant.cu``, the conv
as one product on ``csrc/gemm_mma.cuh``'s main loop as for the fp conv:
w8a8 on its int8 tensor-core tile, w8a16 on the fp conv's tiles with the
codes widened; plain version ``conv2d_quant_plain``, the exact
``quant.qconv.conv2d_q``): x
(B, H, W, Cin), w_q int8 (kh, kw, Cin, Cout), w_scale float32 (Cout,),
stride (sh, sw), the same two modes and the same epilogue. In w8a8 the
int32 sums must not overflow: kh·kw·Cin·127² < 2³¹ is checked. The
reference's tiling arguments are checked by its rule and do not change
the result, as for the fp conv2d.

``conv1d_depthwise_quant`` is the depthwise counterpart (the TPU kernel
``conv1d_depthwise_quant_pallas``; CUDA ``csrc/conv1d_depthwise_quant.cu``
on the float conv's staged body and plan, ``sliding_conv1d.depthwise_launch``;
plain version ``conv1d_depthwise_quant_plain``, the exact
``quant.qconv.conv1d_depthwise_q``): w_q int8 (K, C), w_scale float32 per
channel, (C,) or (1, C), bias (C,) or None, the same two modes and the same
epilogue.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, sliding_conv1d, sliding_conv2d
from repro_torch.kernels.sliding_conv1d import ACTIVATIONS
from repro_torch.quant import qconv

MODES = {"w8a8": 0, "w8a16": 1}
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# x, w, scale, bias, out_scale, y, ws; B, L, Cin, Cout, K, stride, Lout,
# act, mode, x_kind, y_kind, tile, splits, per, va, vb; stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
# x, w, scale, bias, out_scale, y, ws; B, H, W, Cin, Cout, kh, kw, sh, sw,
# oh, ow, act, mode, x_kind, y_kind, tile, splits, per, va, vb; stream
_2D_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 20 + [ctypes.c_void_p]
# x, w, scale, bias, out_scale, y; B, L, C, K, stride, Lout, act, mode,
# x_kind, y_kind, rows, stages, blocks, copy_bytes; stream
_DW_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p]


def _check(x, w_q, w_scale, bias, x_scale, mode, stride, activation,
           out_dtype) -> int:
    if x.dim() != 3 or w_q.dim() != 3 or w_q.shape[1] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w_q.shape)} do not "
                         "form (B, L, Cin) and (K, Cin, Cout)")
    if w_scale.shape != (w_q.shape[2],):
        raise ValueError(f"w_scale {tuple(w_scale.shape)} is not (Cout,)")
    _check_operands(x, w_q, bias, x_scale, mode, activation, out_dtype)
    return _out_len(x, w_q, stride)


def _check_operands(x, w_q, bias, x_scale, mode, activation,
                    out_dtype) -> None:
    """The checks every int8 conv shares (w_q's last axis is the output
    channel)."""
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
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")


def _out_len(x, w_q, stride) -> int:
    if stride < 1:
        raise ValueError(f"stride {stride} < 1")
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


def _run_product(entry, argtypes, x, w_q, w_scale, bias, x_scale, out_scale,
                 mode, activation, out_dtype, y_shape, dims, geometry):
    """One launch of an int8 conv's product on ``csrc/gemm_mma.cuh`` (rows
    13 and 14): C entry ``entry`` of the library of that name, ``dims`` its
    shape arguments, ``geometry(x, w_q)`` the plan, the copy widths and
    the splits' workspace for contiguous x and w_q. Returns y."""
    dev = x.device
    s, b32, os32 = _epilogue_operands(dev, w_q, w_scale, bias, x_scale,
                                      out_scale, mode)
    fn = build.entry(entry, entry, argtypes)
    x, w_q = x.contiguous(), w_q.contiguous()
    plan, va, vb, ws = geometry(x, w_q)
    odt = torch.int8 if out_scale is not None else out_dtype
    y = torch.empty(y_shape, dtype=odt, device=dev)
    code = fn(
        x.data_ptr(), w_q.data_ptr(), s.data_ptr(),
        None if b32 is None else b32.data_ptr(),
        None if os32 is None else os32.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), *dims,
        ACTIVATIONS[activation], MODES[mode], _KINDS[x.dtype], _KINDS[odt],
        plan.tile.id, plan.splits, plan.per, va, vb,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(entry, code)
    return y


def _launch(x, w_q, w_scale, bias, x_scale, out_scale, mode, stride,
            activation, out_dtype, out_len):
    B, L, Cin = x.shape
    K, _, Cout = w_q.shape
    y = _run_product(
        "sliding_conv_quant", _ARGTYPES, x, w_q, w_scale, bias, x_scale,
        out_scale, mode, activation, out_dtype, (B, out_len, Cout),
        (B, L, Cin, Cout, K, stride, out_len),
        lambda x, w_q: sliding_conv1d.conv1d_launch(x, w_q, stride, out_len))
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
# 2-D
# ---------------------------------------------------------------------------

INT32_TERMS = 2 ** 31 // 127 ** 2  # w8a8: kh·kw·Cin below this cannot overflow


def _check_2d(x, w_q, w_scale, bias, x_scale, mode, stride, activation,
              out_dtype, tile_h=sliding_conv2d.DEFAULT_TILE_H,
              tile_w=sliding_conv2d.DEFAULT_TILE_W, cin_block=None,
              cout_block=None, regime=None) -> tuple[int, int]:
    """Raise on what the kernel does not take; return (oh, ow)."""
    oh, ow = sliding_conv2d._check(x, w_q, bias, stride, activation, tile_h,
                                   tile_w, cin_block, cout_block, regime)
    if w_scale.shape != (w_q.shape[3],):
        raise ValueError(f"w_scale {tuple(w_scale.shape)} is not (Cout,)")
    _check_operands(x, w_q, bias, x_scale, mode, activation, out_dtype)
    kh, kw, cin = w_q.shape[:3]
    if mode == "w8a8" and kh * kw * cin >= INT32_TERMS:
        raise ValueError(f"{kh}x{kw}x{cin} int8 products can overflow the "
                         "int32 sum")
    return oh, ow


def conv2d_quant_plain(
    x, w_q, w_scale, bias=None, *, x_scale=None, out_scale=None,
    mode: str = "w8a8", stride: tuple[int, int] = (1, 1),
    activation: str = "none", out_dtype=torch.float32,
):
    """The 2-D kernel's function in plain torch: ``qconv.conv2d_q`` with
    exact accumulation (w8a8) on an already padded input."""
    stride = tuple(stride)
    _check_2d(x, w_q, w_scale, bias, x_scale, mode, stride, activation,
              out_dtype)
    return qconv.conv2d_q(
        x, qconv.QuantizedWeight(w_q, w_scale), bias, mode=mode,
        x_scale=x_scale, out_scale=out_scale, stride=stride, padding="VALID",
        activation=activation, accumulate="int32", out_dtype=out_dtype,
    )


def _launch_2d(x, w_q, w_scale, bias, x_scale, out_scale, mode, stride,
               activation, out_dtype, oh, ow):
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = w_q.shape
    y = _run_product(
        "sliding_conv2d_quant", _2D_ARGTYPES, x, w_q, w_scale, bias, x_scale,
        out_scale, mode, activation, out_dtype, (B, oh, ow, Cout),
        (B, H, W, Cin, Cout, kh, kw, stride[0], stride[1], oh, ow),
        lambda x, w_q: sliding_conv2d.product_launch(x, w_q, stride, oh, ow))
    conv2d_quant.launches += 1
    return y


def conv2d_quant(
    x, w_q, w_scale, bias=None, *, x_scale=None, out_scale=None,
    mode: str = "w8a8", stride: tuple[int, int] = (1, 1),
    activation: str = "none", out_dtype=torch.float32,
    tile_h: int = sliding_conv2d.DEFAULT_TILE_H,
    tile_w: int = sliding_conv2d.DEFAULT_TILE_W,
    cin_block: int | None = None, cout_block: int | None = None,
    regime: str | None = None,
):
    """VALID int8 sliding conv2d + dequant + bias + activation (+ requant):
    the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor.
    ``conv2d_quant.launches`` counts kernel launches."""
    stride = tuple(stride)
    oh, ow = _check_2d(x, w_q, w_scale, bias, x_scale, mode, stride,
                       activation, out_dtype, tile_h, tile_w, cin_block,
                       cout_block, regime)
    if x.device.type == "cuda":
        return _launch_2d(x, w_q, w_scale, bias, x_scale, out_scale, mode,
                          stride, activation, out_dtype, oh, ow)
    if x.device.type == "cpu":
        return conv2d_quant_plain(
            x, w_q, w_scale, bias, x_scale=x_scale, out_scale=out_scale,
            mode=mode, stride=stride, activation=activation,
            out_dtype=out_dtype)
    raise ValueError(f"no sliding_conv2d_quant for device {x.device}")


conv2d_quant.launches = 0


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
    _check_operands(x, w_q, bias, x_scale, mode, activation, out_dtype)
    return _out_len(x, w_q, stride)


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
    plan, cb = sliding_conv1d.depthwise_launch(x, w_q.shape[0], stride,
                                               out_len)
    odt = torch.int8 if out_scale is not None else out_dtype
    y = torch.empty((B, out_len, C), dtype=odt, device=dev)
    code = fn(
        x.data_ptr(), w_q.data_ptr(), s.data_ptr(),
        None if b32 is None else b32.data_ptr(),
        None if os32 is None else os32.data_ptr(), y.data_ptr(),
        B, L, C, w_q.shape[0], stride, out_len, ACTIVATIONS[activation],
        MODES[mode], _KINDS[x.dtype], _KINDS[odt],
        plan.rows, plan.stages, plan.blocks, cb,
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
