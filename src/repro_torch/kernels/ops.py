"""Kernel dispatch: the layer-facing entry points of the kernels.

The subset of ``repro.kernels.ops`` that whisper's and jamba's serving and
training paths and llava's serving path reach:

  * ``conv1d``: padding outside the kernel, then the backend. ``sliding``
    is the plain tap loop of ``core.conv`` with an unfused epilogue;
    ``sliding_pallas`` (the reference's name, kept so one command line
    drives both packages) is the fused CUDA kernel, differentiable through
    ``Conv1dSliding`` (the reference's ``_conv1d_sliding_op`` custom VJP);
    ``xla`` is ``torch.nn.functional.conv1d`` with an unfused epilogue.
    ``sliding`` and ``xla`` differentiate by plain autograd. With
    ``precision`` "w8a8" or "w8a16" it runs the int8 sliding conv kernel
    (``sliding_pallas`` only, inference only): float operands quantize
    here, ``out_scale`` fuses a requant, and ``_guard_quant_scales`` screens
    unusable scales as the reference does.
  * ``conv1d_depthwise``: the mamba conv. Padding outside the kernel, then
    the depthwise CUDA kernel with bias and activation fused,
    differentiable through ``Conv1dDepthwise`` (the reference's
    ``_conv1d_depthwise_op`` custom VJP); with ``precision`` "w8a8" or
    "w8a16" the int8 depthwise kernel (inference only), float operands
    quantized here. Each call is logged in ``CONV1D_DW_DISPATCH`` under the
    reference's ``conv1d_dw_key``.
  * ``conv2d``: llava's patch embedding. ``sliding`` and ``sliding_pallas``
    run the 2-D sliding conv kernel (the reference's Pallas rung) with
    bias and activation fused, after padding outside it, differentiable
    through ``Conv2dSliding`` (the reference's ``_conv2d_sliding_op``
    custom VJP); ``xla`` is ``torch.nn.functional.conv2d`` (TF32 off) and
    ``im2col_gemm`` the plain column-tensor twin, each with an unfused
    epilogue and plain autograd; a dilated conv goes to the ``core.conv``
    twins, as in the reference. Each kernel call is logged in
    ``CONV2D_DISPATCH`` under the reference's ``conv2d_key``, a
    differentiable call also under its ``grad=True`` key. With
    ``precision`` "w8a8" or "w8a16" it runs the int8 conv2d kernel (the
    sliding backends only, inference only), float operands quantized here,
    each call logged in ``CONV2D_QUANT_DISPATCH`` under the
    precision-keyed ``conv2d_key``.
  * ``attention_decode``: the decode-attention kernel over a float or int8
    cache, with a dispatch log keyed like the reference's
    ``ATTN_DECODE_DISPATCH``.

The reference demotes a failing Pallas kernel down a ladder of compiled
twins. There is no ladder here: a CUDA tensor goes to the kernel or the
call raises, and the plain versions serve only CPU tensors. For the same
reason the reference's measured quant-regression guard
(``_quant_fallback_reason``, which acts only on tuned timings in an
autotune cache) has no counterpart: with no cache, as in the reference
with an empty one, a quantized call goes to the quant kernel.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from repro_torch.core import conv as core_conv
from repro_torch.health import HEALTH
from repro_torch.kernels import attention_decode as attn_dec
from repro_torch.kernels import (
    autotune, sliding_conv1d, sliding_conv2d, sliding_conv_bwd,
    sliding_conv_quant,
)
from repro_torch.kernels.sliding_conv1d import apply_activation
from repro_torch.quant import qconv
from repro_torch.quant.apply import quantize_depthwise_weight, scale_reason

CONV_BACKENDS = ("sliding", "sliding_pallas", "xla")
CONV2D_BACKENDS = ("sliding", "sliding_pallas", "xla", "im2col_gemm")
PRECISIONS = ("fp", "w8a8", "w8a16")


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
CONV1D_DW_DISPATCH = DispatchLog()
CONV2D_DISPATCH = DispatchLog()
CONV2D_QUANT_DISPATCH = DispatchLog()


def _pad1d(x, padding, k, dilation=1):
    lo, hi = core_conv._resolve_pad_1d(padding, k, dilation)
    if lo or hi:
        x = F.pad(x, (0, 0, lo, hi))
    return x


def _guard_quant_scales(site, x, w, w_scale, x_scale):
    """Numeric guard of the int8 chain: a zero or non-finite scale would
    emit all-zero or NaN codes. Returns ``(x_scale, to_float)``: with float
    weights the site serves the fp path, with float activations it takes a
    dynamic absmax scale, each with a health event; int8 operands whose
    scale is unusable cannot be recovered here and raise. Reads the scales
    on the host: a synchronise per quantized call on the card."""
    bad_w = scale_reason(w_scale) if w.dtype == torch.int8 else None
    if bad_w:
        HEALTH.record(site, bad_w, "error:w_scale")
        raise ValueError(f"unusable int8 w_scale at {site} ({bad_w})")
    bad_x = scale_reason(x_scale)
    if not bad_x:
        return x_scale, False
    if x.dtype == torch.int8:
        HEALTH.record(site, bad_x, "error:x_scale")
        raise ValueError(f"unusable x_scale for int8 input at {site} ({bad_x})")
    if w.dtype != torch.int8:
        HEALTH.record(site, bad_x, "fallback:fp")
        return x_scale, True
    HEALTH.record(site, bad_x, "fallback:dynamic_scale")
    return None, False


def _quant_operands(x, w, w_scale, x_scale, precision,
                    quantize_weight=qconv.quantize_weight):
    """Quantize the float operands onto their int8 grids (weights per
    output channel by ``quantize_weight``, activations per tensor).
    Returns (x, w_q, w_scale, x_scale, out_dtype)."""
    out_dtype = torch.float32 if x.dtype == torch.int8 else x.dtype
    if w.dtype != torch.int8:
        qw = quantize_weight(w)
        w, w_scale = qw.q, qw.scale
    elif w_scale is None:
        raise ValueError("int8 weights need their w_scale")
    if precision == "w8a8" and x.dtype != torch.int8:
        x_scale = qconv.act_scale(x) if x_scale is None else x_scale
        x = qconv.quantize_act(x, x_scale)
    return x, w, w_scale, x_scale, out_dtype


def _check_quant_dispatch(precision, backend, backends=("sliding_pallas",)):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")
    if backend not in backends:
        raise ValueError(
            f"precision={precision!r} is implemented for the "
            f"{' and '.join(backends)} backend{'s' * (len(backends) > 1)} "
            f"only (got backend={backend!r})")


def _conv1d_quant(x, w, *, stride, padding, backend, bias, activation,
                  precision, w_scale, x_scale, out_scale):
    """The quantized branch of ``conv1d``: pad (an int8 input with code 0),
    screen the scales, quantize the float operands, then the int8 kernel."""
    _check_quant_dispatch(precision, backend)
    x = _pad1d(x, padding, w.shape[0])
    site = f"conv1d.{precision}"
    x_scale, to_float = _guard_quant_scales(site, x, w, w_scale, x_scale)
    if to_float:  # unusable calibrated scale, float operands: the fp path
        return conv1d(x, w, stride=stride, backend=backend, bias=bias,
                      activation=activation)
    x, w, w_scale, x_scale, out_dtype = _quant_operands(
        x, w, w_scale, x_scale, precision)
    return sliding_conv_quant.conv1d_quant(
        x, w, w_scale, bias, x_scale=x_scale, out_scale=out_scale,
        mode=precision, stride=stride, activation=activation,
        out_dtype=out_dtype)


def epilogue_unfused(y, bias, activation):
    """bias + activation outside the kernel (the non-kernel backends), with
    the fused epilogue's numerics: both in float32, one cast back."""
    if bias is None and activation in (None, "none"):
        return y
    yf = y.float()
    if bias is not None:
        yf = yf + bias.float()
    return apply_activation(yf, activation).to(y.dtype)


class Conv1dSliding(torch.autograd.Function):
    """VALID sliding conv1d + bias + activation with its backward on the
    kernels. Forward saves (x, w, bias, z), z the kernel's post-bias
    pre-activation (none with activation "none": y is z then). Backward:
    ``dz = act'(z) · dy`` in x's type; dx through the forward conv kernel
    on the dilated gradient and the flipped weights; dw and db through the
    dw kernel, cast to w's and bias's types. Grads nobody asked for are not
    computed. CPU tensors run the kernels' plain versions."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, activation):
        if activation in (None, "none"):
            y = sliding_conv1d.conv1d_sliding(x, w, bias, stride=stride)
            z = None
        else:
            y, z = sliding_conv1d.conv1d_sliding(
                x, w, bias, stride=stride, activation=activation,
                save_preact=True)
        ctx.save_for_backward(x, w, bias, z)
        ctx.stride, ctx.activation = stride, activation
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, bias, z = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dz = sliding_conv_bwd.act_bwd(dy, z, ctx.activation).to(x.dtype)
        dx = dw = db = None
        if need_x:
            dx = sliding_conv_bwd.conv1d_dx(dz, w, stride=ctx.stride,
                                            L=x.shape[1])
        if need_w or need_b:
            dw, db = sliding_conv_bwd.conv1d_bwd_dw(
                x, dz, w.shape[0], stride=ctx.stride,
                has_bias=bias is not None)
            dw = dw.to(w.dtype)
            db = None if db is None else db.to(bias.dtype)
        return dx, dw, db, None, None


class Conv1dDepthwise(torch.autograd.Function):
    """VALID depthwise conv1d + bias + activation with its backward on the
    kernels, as ``Conv1dSliding``: forward saves (x, w, bias, z), z the
    depthwise kernel's post-bias pre-activation (none with activation
    "none"). Backward: ``dz = act'(z) · dy`` in x's type; dx through the
    forward depthwise kernel on the dilated gradient and the flipped taps;
    dw and db through the depthwise dw kernel, cast to w's and bias's
    types. Grads nobody asked for are not computed. CPU tensors run the
    kernels' plain versions."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, activation):
        if activation in (None, "none"):
            y = sliding_conv1d.conv1d_depthwise(x, w, bias, stride=stride)
            z = None
        else:
            y, z = sliding_conv1d.conv1d_depthwise(
                x, w, bias, stride=stride, activation=activation,
                save_preact=True)
        ctx.save_for_backward(x, w, bias, z)
        ctx.stride, ctx.activation = stride, activation
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, bias, z = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dz = sliding_conv_bwd.act_bwd(dy, z, ctx.activation).to(x.dtype)
        dx = dw = db = None
        if need_x:
            dx = sliding_conv_bwd.conv1d_depthwise_dx(
                dz, w, stride=ctx.stride, L=x.shape[1])
        if need_w or need_b:
            dw, db = sliding_conv_bwd.conv1d_depthwise_bwd_dw(
                x, dz, w.shape[0], stride=ctx.stride,
                has_bias=bias is not None)
            dw = dw.to(w.dtype)
            db = None if db is None else db.to(bias.dtype)
        return dx, dw, db, None, None


class Conv2dSliding(torch.autograd.Function):
    """VALID sliding conv2d + bias + activation with its backward on the
    kernels, as ``Conv1dSliding``: forward saves (x, w, bias, z), z the
    2-D kernel's post-bias pre-activation (none with activation "none").
    Backward: ``dz = act'(z) · dy`` in x's type; dx through the forward 2-D
    kernel on the dilated gradient and the flipped, transposed weights; dw
    and db through the 2-D dw kernel, cast to w's and bias's types. Grads
    nobody asked for are not computed: an input that needs none (an image)
    costs no dx conv. CPU tensors run the kernels' plain versions."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, activation, tiles, bwd_tiles):
        if activation in (None, "none"):
            y = sliding_conv2d.conv2d_sliding(x, w, bias, stride=stride,
                                              **tiles)
            z = None
        else:
            y, z = sliding_conv2d.conv2d_sliding(
                x, w, bias, stride=stride, activation=activation,
                save_preact=True, **tiles)
        ctx.save_for_backward(x, w, bias, z)
        ctx.stride, ctx.activation = stride, activation
        ctx.bwd_tiles = bwd_tiles
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, bias, z = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dz = sliding_conv_bwd.act_bwd(dy, z, ctx.activation).to(x.dtype)
        dx = dw = db = None
        if need_x:
            dx = sliding_conv_bwd.conv2d_dx(dz, w, stride=ctx.stride,
                                            H=x.shape[1], W=x.shape[2])
        if need_w or need_b:
            dw, db = sliding_conv_bwd.conv2d_bwd_dw(
                x, dz, w.shape[:2], stride=ctx.stride,
                has_bias=bias is not None, **ctx.bwd_tiles)
            dw = dw.to(w.dtype)
            db = None if db is None else db.to(bias.dtype)
        return dx, dw, db, None, None, None, None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding="VALID",
    backend: str = "sliding_pallas",
    bias: torch.Tensor | None = None,
    activation: str = "none",
    precision: str = "fp",
    w_scale: torch.Tensor | None = None,
    x_scale: torch.Tensor | None = None,
    out_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-channel 1-D convolution + bias + activation. x: (B, L, Cin),
    w: (K, Cin, Cout); padding VALID / SAME / CAUSAL / (lo, hi).

    ``precision`` "w8a8" / "w8a16" selects the int8 kernel: ``w`` is int8
    with its per-Cout ``w_scale``, or float and quantized here; in w8a8 a
    float ``x`` is quantized onto ``x_scale`` (dynamic absmax when None),
    an int8 ``x`` comes with its ``x_scale``, and ``out_scale`` requantizes
    the output to int8 after the activation."""
    if precision != "fp":
        return _conv1d_quant(
            x, w, stride=stride, padding=padding, backend=backend, bias=bias,
            activation=activation, precision=precision, w_scale=w_scale,
            x_scale=x_scale, out_scale=out_scale)
    if backend == "xla":
        lo, hi = core_conv._resolve_pad_1d(padding, w.shape[0], 1)
        y = F.conv1d(
            F.pad(x, (0, 0, lo, hi)).transpose(1, 2), w.permute(2, 1, 0),
            stride=stride,
        ).transpose(1, 2).to(x.dtype)
        return epilogue_unfused(y, bias, activation)
    x = _pad1d(x, padding, w.shape[0])
    if backend == "sliding_pallas":
        if _needs_grad(x, w, bias):
            return Conv1dSliding.apply(x, w, bias, stride, activation)
        # nothing to differentiate (serving): the kernel saves no residual
        return sliding_conv1d.conv1d_sliding(
            x, w, bias, stride=stride, activation=activation
        )
    if backend == "sliding":
        y = core_conv.conv1d_sliding(x, w, stride=stride, padding="VALID")
        return epilogue_unfused(y, bias, activation)
    raise ValueError(f"unknown conv backend {backend!r}; one of {CONV_BACKENDS}")


def conv1d_depthwise(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding="CAUSAL",
    bias: torch.Tensor | None = None,
    activation: str = "none",
    precision: str = "fp",
    w_scale: torch.Tensor | None = None,
    x_scale: torch.Tensor | None = None,
    out_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Depthwise 1-D sliding conv + bias + activation in one launch (the
    mamba conv path). x: (B, L, C), w: (K, C); padding VALID / SAME /
    CAUSAL / (lo, hi).

    ``precision`` "w8a8" / "w8a16" runs the int8 depthwise kernel: ``w``
    is int8 with its per-channel ``w_scale`` ((C,) or (1, C)), or float and
    quantized here; in w8a8 a float ``x`` is quantized onto ``x_scale``
    (dynamic absmax when None) and ``out_scale`` requantizes the output.
    In floating point a call whose inputs need a gradient goes through
    ``Conv1dDepthwise``; the int8 path is inference only."""
    x = _pad1d(x, padding, w.shape[0])
    impl = "cuda" if x.device.type == "cuda" else "plain"
    if precision == "fp":
        kind = str(x.dtype).removeprefix("torch.")
        CONV1D_DW_DISPATCH[autotune.conv1d_dw_key(
            *x.shape, w.shape[0], stride, kind)] = impl
        if _needs_grad(x, w, bias):
            return Conv1dDepthwise.apply(x, w, bias, stride, activation)
        # nothing to differentiate (serving): the kernel saves no residual
        return sliding_conv1d.conv1d_depthwise(x, w, bias, stride=stride,
                                               activation=activation)
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")
    if _needs_grad(x, w, bias):
        raise NotImplementedError(
            f"conv1d_depthwise precision={precision!r} is inference only")
    site = f"conv1d_depthwise.{precision}"
    x_scale, to_float = _guard_quant_scales(site, x, w, w_scale, x_scale)
    if to_float:  # unusable calibrated scale, float operands: the fp path
        return conv1d_depthwise(x, w, stride=stride, padding="VALID",
                                bias=bias, activation=activation)
    x, w, w_scale, x_scale, out_dtype = _quant_operands(
        x, w, w_scale, x_scale, precision, quantize_depthwise_weight)
    CONV1D_DW_DISPATCH[autotune.conv1d_dw_key(
        *x.shape, w.shape[0], stride, precision)] = impl
    return sliding_conv_quant.conv1d_depthwise_quant(
        x, w, w_scale, bias, x_scale=x_scale, out_scale=out_scale,
        mode=precision, stride=stride, activation=activation,
        out_dtype=out_dtype)


def _bwd_tile2d(x, w, stride, explicit_h, explicit_w):
    """The dw kernel's tiles: the explicit ones, else the defaults (the
    reference consults its tuning cache under the ``grad=True`` key here;
    the port has none). The key is logged in ``CONV2D_DISPATCH``."""
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    key = autotune.conv2d_key(B, H, W, Cin, Cout, kh, kw, *stride,
                              str(x.dtype).removeprefix("torch."), grad=True)
    CONV2D_DISPATCH[key] = "cuda" if x.device.type == "cuda" else "plain"
    return (sliding_conv2d.DEFAULT_TILE_H if explicit_h is None else explicit_h,
            sliding_conv2d.DEFAULT_TILE_W if explicit_w is None else explicit_w)


def _conv2d_quant(x, w, *, stride, padding, dilation, backend, bias,
                  activation, tiles, precision, w_scale, x_scale, out_scale):
    """The quantized branch of ``conv2d`` (the reference's ``ops.py``
    int8 conv2d): pad (an int8 input with code 0), screen the scales,
    quantize the float operands, then the int8 conv2d kernel. An unusable
    calibrated scale with float operands demotes the call to the fp conv
    kernel, as in the reference, logged as "fp" under the call's key."""
    _check_quant_dispatch(precision, backend, ("sliding", "sliding_pallas"))
    if dilation != (1, 1):
        raise ValueError("quantized convs cover dilation == 1 only")
    if _needs_grad(x, w, bias):
        raise NotImplementedError(
            f"conv2d precision={precision!r} is inference only")
    kh, kw = w.shape[:2]
    x = core_conv._pad_2d(x, core_conv._resolve_pad_2d(padding, kh, kw,
                                                       (1, 1)))
    key = autotune.conv2d_key(*x.shape, w.shape[3], kh, kw, *stride,
                              precision)
    site = f"conv2d.{precision}"
    x_scale, to_float = _guard_quant_scales(site, x, w, w_scale, x_scale)
    if to_float:  # unusable calibrated scale, float operands: the fp path
        CONV2D_QUANT_DISPATCH[key] = "fp"
        return conv2d(x, w, stride=stride, backend=backend, bias=bias,
                      activation=activation, **tiles)
    x, w, w_scale, x_scale, out_dtype = _quant_operands(
        x, w, w_scale, x_scale, precision)
    CONV2D_QUANT_DISPATCH[key] = "cuda" if x.device.type == "cuda" else "plain"
    return sliding_conv_quant.conv2d_quant(
        x, w, w_scale, bias, x_scale=x_scale, out_scale=out_scale,
        mode=precision, stride=stride, activation=activation,
        out_dtype=out_dtype, **tiles)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: tuple[int, int] = (1, 1),
    padding="VALID",
    dilation: tuple[int, int] = (1, 1),
    backend: str = "sliding",
    bias: torch.Tensor | None = None,
    activation: str = "none",
    tile_h: int | None = None,
    tile_w: int | None = None,
    cin_block: int | None = None,
    cout_block: int | None = None,
    regime: str | None = None,
    bwd_tile_h: int | None = None,
    bwd_tile_w: int | None = None,
    precision: str = "fp",
    w_scale: torch.Tensor | None = None,
    x_scale: torch.Tensor | None = None,
    out_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-channel 2-D convolution + bias + activation. x: (B, H, W, Cin),
    w: (kh, kw, Cin, Cout); padding VALID / SAME / ((lo, hi), (lo, hi)).

    The tiling arguments are the reference's; they are checked and do not
    change the result. On the sliding backends a call whose inputs need a
    gradient goes through ``Conv2dSliding``. ``precision`` "w8a8" /
    "w8a16" selects the int8 kernel (inference only): ``w`` is int8 with
    its per-Cout ``w_scale``, or float and quantized here; in w8a8 a float
    ``x`` is quantized onto ``x_scale`` (dynamic absmax when None), an int8
    ``x`` comes with its ``x_scale``, and ``out_scale`` requantizes the
    output to int8 after the activation."""
    stride, dilation = tuple(stride), tuple(dilation)
    tiles = dict(
        tile_h=sliding_conv2d.DEFAULT_TILE_H if tile_h is None else tile_h,
        tile_w=sliding_conv2d.DEFAULT_TILE_W if tile_w is None else tile_w,
        cin_block=cin_block, cout_block=cout_block, regime=regime)
    if precision != "fp":
        return _conv2d_quant(
            x, w, stride=stride, padding=padding, dilation=dilation,
            backend=backend, bias=bias, activation=activation, tiles=tiles,
            precision=precision, w_scale=w_scale, x_scale=x_scale,
            out_scale=out_scale)
    if backend not in CONV2D_BACKENDS:
        raise ValueError(
            f"unknown conv backend {backend!r}; one of {CONV2D_BACKENDS}")
    if backend == "xla":
        y = core_conv.conv2d_xla(x, w, stride=stride, padding=padding,
                                 dilation=dilation)
        return epilogue_unfused(y, bias, activation)
    if dilation != (1, 1):
        y = core_conv.conv2d(
            x, w, stride=stride, padding=padding, dilation=dilation,
            backend="im2col_gemm" if backend == "im2col_gemm" else "sliding")
        return epilogue_unfused(y, bias, activation)
    kh, kw = w.shape[:2]
    x = core_conv._pad_2d(x, core_conv._resolve_pad_2d(padding, kh, kw,
                                                       dilation))
    if backend == "im2col_gemm":
        y = core_conv.conv2d_im2col(x, w, stride=stride)
        return epilogue_unfused(y, bias, activation)
    B, H, W, Cin = x.shape
    key = autotune.conv2d_key(B, H, W, Cin, w.shape[3], kh, kw, *stride,
                              str(x.dtype).removeprefix("torch."))
    CONV2D_DISPATCH[key] = "cuda" if x.device.type == "cuda" else "plain"
    if _needs_grad(x, w, bias):
        bth, btw = _bwd_tile2d(x, w, stride, bwd_tile_h, bwd_tile_w)
        bwd_tiles = dict(tile_h=bth, tile_w=btw, cin_block=cin_block,
                         cout_block=cout_block)
        return Conv2dSliding.apply(x, w, bias, stride, activation, tiles,
                                   bwd_tiles)
    # nothing to differentiate (serving): the kernel saves no residual
    return sliding_conv2d.conv2d_sliding(x, w, bias, stride=stride,
                                         activation=activation, **tiles)


def attention_decode(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    lengths: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused decode attention against the KV cache. q: (B, H, D) the new
    token's query heads; k/v: (B, S, KV, D), float rows, or int8 codes with
    their float32 ``k_scale``/``v_scale`` (B, S, KV, 1); lengths: (B,)
    int32 valid prefix per slot (decode: pos + 1; cross-attention: encoder
    lengths; 0 gives a zero row). GQA: H = KV * G. Returns (B, H, D)
    float32."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"H={H} not divisible by KV={KV}")
    G = H // KV
    quantized = k.dtype == torch.int8
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError("int8 KV cache needs its k_scale/v_scale rows")
    kind = "int8" if quantized else str(k.dtype).removeprefix("torch.")
    key = autotune.attn_dec_key(B, S, KV, G, D, kind)
    ATTN_DECODE_DISPATCH[key] = "cuda" if q.device.type == "cuda" else "plain"
    out = attn_dec.decode_attention(q.reshape(B, KV, G, D), k, v, lengths,
                                    k_scale, v_scale)
    return out.reshape(B, H, D)
