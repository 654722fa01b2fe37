"""Kernel dispatch: the layer-facing entry points of the kernels.

The subset of ``repro.kernels.ops`` that whisper's and jamba's serving and
training paths and llava's serving path reach:

  * ``conv1d``: padding outside the kernel, then the backend.
    ``sliding_pallas`` (the model layers' name, kept so one command line
    drives both packages) is the fused CUDA kernel, differentiable through
    ``Conv1dSliding`` (the reference's ``_conv1d_sliding_op`` custom VJP);
    ``sliding``, the reference's name for its kernel, is the same on a CUDA
    tensor and the plain tap loop of ``core.conv`` with an unfused epilogue
    and plain autograd on a CPU tensor; ``xla`` is
    ``torch.nn.functional.conv1d`` with an unfused epilogue and plain
    autograd. The paper's
    GEMM baselines, forward only and each with an unfused epilogue:
    ``im2col_gemm`` is the fused im2col kernel (the column built on chip),
    ``im2col_hbm`` the column tensor in device memory, then the GEMM
    kernel. A dilated conv goes to the ``core.conv`` twins, as in the
    reference. With
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
    custom VJP); ``xla`` is ``torch.nn.functional.conv2d`` (TF32 off),
    with an unfused epilogue and plain autograd; ``im2col_gemm`` and
    ``im2col_hbm`` are the GEMM baselines as for ``conv1d`` (the 2-D
    fused im2col kernel; the column tensor, then the GEMM kernel); a
    dilated conv goes to the ``core.conv`` twins, as in the reference.
    Each sliding kernel call is logged in
    ``CONV2D_DISPATCH`` under the reference's ``conv2d_key``, a
    differentiable call also under its ``grad=True`` key. With
    ``precision`` "w8a8" or "w8a16" it runs the int8 conv2d kernel (the
    sliding backends only, inference only), float operands quantized here,
    each call logged in ``CONV2D_QUANT_DISPATCH`` under the
    precision-keyed ``conv2d_key``.
  * ``attention_decode``: the decode-attention kernel over a float or int8
    cache, with a dispatch log keyed like the reference's
    ``ATTN_DECODE_DISPATCH``.
  * ``matmul``: the tiled GEMM kernel of the baselines.
  * ``pool1d``: VALID sliding pooling along L (sum, avg, max) on the pool
    kernel, differentiable through ``Pool1d`` (the reference's
    ``_pool1d_op`` custom VJP): sum/avg backward on the forward sum kernel
    over the padded cotangent, max backward on the two-launch max-gradient
    kernel. Each call is logged in ``POOL1D_DISPATCH`` under the
    reference's ``pool1d_key``.

The reference demotes a failing Pallas kernel down a ladder of compiled
twins. There is no ladder here: a CUDA tensor goes to the kernel or the
call raises, and the plain versions serve only CPU tensors. For the same
reason the reference's measured quant-regression guard
(``_quant_fallback_reason``, which acts only on tuned timings in an
autotune cache) has no counterpart: with no cache, as in the reference
with an empty one, a quantized call goes to the quant kernel.

Each entry records its dispatch where it picks its kernel (``_dispatch``),
as the reference's ``_ladder`` does: when tracing or
``obs.enable_dispatch`` is armed, the kernel call runs in a
``kernel.dispatch`` span and adds to ``dispatch.calls``,
``dispatch.seconds_total`` and ``dispatch.est_hbm_bytes_total`` under its
autotune shape key, with rung ``cuda`` for the kernel and ``plain`` for a
CPU tensor's plain version. The reference dispatches at trace time, so its
seconds are trace cost and its calls count traces; here every eager call
passes through, and on the card the seconds are host launch time (nothing
synchronises inside the span). Disarmed, the path is one flag check.
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from repro_torch.core import conv as core_conv
from repro_torch.health import HEALTH
from repro_torch.kernels import attention_decode as attn_dec
from repro_torch.kernels import (
    autotune, im2col_gemm, sliding_conv1d, sliding_conv2d, sliding_conv_bwd,
    sliding_conv_quant, sliding_pool,
)
from repro_torch.kernels.sliding_conv1d import apply_activation
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import DispatchLog
from repro_torch.quant import qconv
from repro_torch.quant.apply import quantize_depthwise_weight, scale_reason

CONV_BACKENDS = ("sliding", "sliding_pallas", "xla", "im2col_gemm",
                 "im2col_hbm")
CONV2D_BACKENDS = CONV_BACKENDS  # conv2d takes the same five
PRECISIONS = ("fp", "w8a8", "w8a16")


# named, as the reference's: its hits mirror into the obs registry, so the
# report CLI rebuilds the serve CLI's ``attn-decode: ... calls=N`` lines
ATTN_DECODE_DISPATCH = DispatchLog("attn_decode")
CONV1D_DW_DISPATCH = DispatchLog()
CONV2D_DISPATCH = DispatchLog()
CONV2D_QUANT_DISPATCH = DispatchLog()
POOL1D_DISPATCH = DispatchLog()


def _dtype_name(t: torch.Tensor) -> str:
    """The dtype field of a shape key: "float32", "bfloat16", ..."""
    return str(t.dtype).removeprefix("torch.")


def _nbytes(*ts) -> int:
    """Bytes of the tensors among ``ts``, each counted once (the
    reference's ``est_hbm_bytes`` over operands and result)."""
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _dispatch(site: str, key, operands: tuple, run):
    """One entry point's kernel call, ``run()``. Disarmed (neither tracing
    nor the dispatch metrics on) that is all it does. Armed, the call runs
    in a ``kernel.dispatch`` span (site, key, rung) and is counted in
    ``dispatch.calls``, ``dispatch.seconds_total`` and
    ``dispatch.est_hbm_bytes_total`` (``operands`` and the result) under
    its autotune shape ``key``: a string, or a callable that gives it,
    evaluated only when armed. No synchronise: on the card the seconds are
    the host's launch time."""
    if not (obs_trace.TRACING or obs_metrics.DISPATCH_ON):
        return run()
    key = key() if callable(key) else key
    rung = "cuda" if operands[0].device.type == "cuda" else "plain"
    t0 = time.perf_counter()
    with obs_trace.span("kernel.dispatch", site=site, key=key, rung=rung):
        out = run()
    dt = time.perf_counter() - t0
    obs_metrics.count_dispatch(dt, float(_nbytes(*operands, out)),
                               site=site, key=key, rung=rung)
    return out


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


def _conv1d_quant(x, w, *, stride, padding, dilation, backend, bias,
                  activation, precision, w_scale, x_scale, out_scale):
    """The quantized branch of ``conv1d``: pad (an int8 input with code 0),
    screen the scales, quantize the float operands, then the int8 kernel."""
    _check_quant_dispatch(precision, backend)
    if dilation != 1:
        raise ValueError("quantized convs cover dilation == 1 only")
    x = _pad1d(x, padding, w.shape[0])
    site = f"conv1d.{precision}"
    x_scale, to_float = _guard_quant_scales(site, x, w, w_scale, x_scale)
    if to_float:  # unusable calibrated scale, float operands: the fp path
        return conv1d(x, w, stride=stride, backend=backend, bias=bias,
                      activation=activation)
    x, w, w_scale, x_scale, out_dtype = _quant_operands(
        x, w, w_scale, x_scale, precision)
    return _dispatch(
        site, lambda: autotune.conv1d_key(*x.shape, w.shape[2], w.shape[0],
                                          stride, precision),
        (x, w, bias, w_scale, x_scale, out_scale),
        lambda: sliding_conv_quant.conv1d_quant(
            x, w, w_scale, bias, x_scale=x_scale, out_scale=out_scale,
            mode=precision, stride=stride, activation=activation,
            out_dtype=out_dtype))


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


def _conv1d_sliding(x, w, bias, stride, activation, backend):
    """The sliding backends of ``conv1d`` on padded ``x``: the kernel (its
    plain version on a CPU tensor) for ``sliding_pallas``, and for
    ``sliding`` on a CUDA tensor; ``core.conv``'s tap loop with an unfused
    epilogue for ``sliding`` on a CPU tensor."""
    if backend == "sliding" and x.device.type != "cuda":
        y = core_conv.conv1d_sliding(x, w, stride=stride, padding="VALID")
        return epilogue_unfused(y, bias, activation)
    if _needs_grad(x, w, bias):
        return Conv1dSliding.apply(x, w, bias, stride, activation)
    # nothing to differentiate (serving): the kernel saves no residual
    return sliding_conv1d.conv1d_sliding(x, w, bias, stride=stride,
                                         activation=activation)


def conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding="VALID",
    dilation: int = 1,
    backend: str = "sliding_pallas",
    bias: torch.Tensor | None = None,
    activation: str = "none",
    precision: str = "fp",
    w_scale: torch.Tensor | None = None,
    x_scale: torch.Tensor | None = None,
    out_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-channel 1-D convolution + bias + activation. x: (B, L, Cin),
    w: (K, Cin, Cout); padding VALID / SAME / CAUSAL / (lo, hi). The
    ``im2col_gemm`` and ``im2col_hbm`` baselines are forward only: a CUDA
    call whose inputs need a gradient raises.

    ``precision`` "w8a8" / "w8a16" selects the int8 kernel: ``w`` is int8
    with its per-Cout ``w_scale``, or float and quantized here; in w8a8 a
    float ``x`` is quantized onto ``x_scale`` (dynamic absmax when None),
    an int8 ``x`` comes with its ``x_scale``, and ``out_scale`` requantizes
    the output to int8 after the activation."""
    if precision != "fp":
        return _conv1d_quant(
            x, w, stride=stride, padding=padding, dilation=dilation,
            backend=backend, bias=bias, activation=activation,
            precision=precision, w_scale=w_scale, x_scale=x_scale,
            out_scale=out_scale)
    if backend not in CONV_BACKENDS:
        raise ValueError(
            f"unknown conv backend {backend!r}; one of {CONV_BACKENDS}")
    if backend == "xla":
        y = core_conv.conv1d_xla(x, w, stride=stride, padding=padding,
                                 dilation=dilation)
        return epilogue_unfused(y, bias, activation)
    if dilation > 1:  # the kernels cover dilation 1; core the rest
        y = core_conv.conv1d(
            x, w, stride=stride, padding=padding, dilation=dilation,
            backend="sliding" if backend.startswith("sliding")
            else "im2col_gemm")
        return epilogue_unfused(y, bias, activation)
    x = _pad1d(x, padding, w.shape[0])
    if backend.startswith("sliding"):
        return _dispatch(
            "conv1d", lambda: autotune.conv1d_key(
                *x.shape, w.shape[2], w.shape[0], stride, _dtype_name(x)),
            (x, w, bias),
            lambda: _conv1d_sliding(x, w, bias, stride, activation, backend))
    if backend == "im2col_gemm":
        y = im2col_gemm.conv1d_im2col_fused(x, w, stride=stride)
    else:
        y = im2col_gemm.conv1d_im2col_hbm(x, w, stride=stride)
    return epilogue_unfused(y, bias, activation)


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
        key = autotune.conv1d_dw_key(*x.shape, w.shape[0], stride,
                                     _dtype_name(x))
        CONV1D_DW_DISPATCH[key] = impl

        def run():
            if _needs_grad(x, w, bias):
                return Conv1dDepthwise.apply(x, w, bias, stride, activation)
            # nothing to differentiate (serving): the kernel saves no residual
            return sliding_conv1d.conv1d_depthwise(x, w, bias, stride=stride,
                                                   activation=activation)

        return _dispatch("conv1d_depthwise", key, (x, w, bias), run)
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
    key = autotune.conv1d_dw_key(*x.shape, w.shape[0], stride, precision)
    CONV1D_DW_DISPATCH[key] = impl
    return _dispatch(
        site, key, (x, w, bias, w_scale, x_scale, out_scale),
        lambda: sliding_conv_quant.conv1d_depthwise_quant(
            x, w, w_scale, bias, x_scale=x_scale, out_scale=out_scale,
            mode=precision, stride=stride, activation=activation,
            out_dtype=out_dtype))


def _bwd_tile2d(x, w, stride, explicit_h, explicit_w):
    """The dw kernel's tiles: the explicit ones, else the defaults (the
    reference consults its tuning cache under the ``grad=True`` key here;
    the port has none). The key is logged in ``CONV2D_DISPATCH``."""
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    key = autotune.conv2d_key(B, H, W, Cin, Cout, kh, kw, *stride,
                              _dtype_name(x), grad=True)
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
    return _dispatch(
        site, key, (x, w, bias, w_scale, x_scale, out_scale),
        lambda: sliding_conv_quant.conv2d_quant(
            x, w, w_scale, bias, x_scale=x_scale, out_scale=out_scale,
            mode=precision, stride=stride, activation=activation,
            out_dtype=out_dtype, **tiles))


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
    gradient goes through ``Conv2dSliding``; the ``im2col_gemm`` and
    ``im2col_hbm`` baselines are forward only (a CUDA call whose inputs
    need a gradient raises). ``precision`` "w8a8" /
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
            backend="sliding" if backend.startswith("sliding")
            else "im2col_gemm")
        return epilogue_unfused(y, bias, activation)
    kh, kw = w.shape[:2]
    x = core_conv._pad_2d(x, core_conv._resolve_pad_2d(padding, kh, kw,
                                                       dilation))
    if backend == "im2col_gemm":  # the fused baseline, not the hbm one
        y = im2col_gemm.conv2d_im2col_fused(x, w, stride=stride)
        return epilogue_unfused(y, bias, activation)
    if backend == "im2col_hbm":
        y = im2col_gemm.conv2d_im2col_hbm(x, w, stride=stride)
        return epilogue_unfused(y, bias, activation)
    B, H, W, Cin = x.shape
    key = autotune.conv2d_key(B, H, W, Cin, w.shape[3], kh, kw, *stride,
                              _dtype_name(x))
    CONV2D_DISPATCH[key] = "cuda" if x.device.type == "cuda" else "plain"

    def run():
        if _needs_grad(x, w, bias):
            bth, btw = _bwd_tile2d(x, w, stride, bwd_tile_h, bwd_tile_w)
            bwd_tiles = dict(tile_h=bth, tile_w=btw, cin_block=cin_block,
                             cout_block=cout_block)
            return Conv2dSliding.apply(x, w, bias, stride, activation, tiles,
                                       bwd_tiles)
        # nothing to differentiate (serving): the kernel saves no residual
        return sliding_conv2d.conv2d_sliding(x, w, bias, stride=stride,
                                             activation=activation, **tiles)

    return _dispatch("conv2d", key, (x, w, bias), run)


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
    kind = "int8" if quantized else _dtype_name(k)
    key = autotune.attn_dec_key(B, S, KV, G, D, kind)
    ATTN_DECODE_DISPATCH[key] = "cuda" if q.device.type == "cuda" else "plain"
    out = _dispatch(
        "attention_decode", key, (q, k, v, k_scale, v_scale),
        lambda: attn_dec.decode_attention(q.reshape(B, KV, G, D), k, v,
                                          lengths, k_scale, v_scale))
    return out.reshape(B, H, D)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B on the tiled GEMM kernel (float32 sums, output in A's
    type; forward only)."""
    return im2col_gemm.matmul(a, b)


# ---------------------------------------------------------------------------
# pool1d
# ---------------------------------------------------------------------------

class Pool1d(torch.autograd.Function):
    """VALID sliding pooling with its backward on the kernels (the
    reference's ``_pool1d_op`` custom VJP). Forward: the pool kernel; it
    saves (x, y) for max only, y the argmax witness. Backward: sum,
    ``sum_pool_bwd(dy)``; avg, ``sum_pool_bwd`` of dy / w (in float32,
    rounded to dy's type); max, ``max_pool_bwd(x, y, dy)`` (one launch),
    each window's gradient split evenly over its tied maxima. dx is cast to
    dy's type. CPU tensors run the kernels' plain versions."""

    @staticmethod
    def forward(ctx, x, window, op, method):
        y = sliding_pool.sliding_pool(x, window=window, op=op, method=method)
        if op == "max":
            ctx.save_for_backward(x, y)
        ctx.window, ctx.op = window, op
        return y

    @staticmethod
    def backward(ctx, dy):
        w = ctx.window
        if ctx.op == "max":
            x, y = ctx.saved_tensors
            dx = sliding_pool.max_pool_bwd(x, y, dy, window=w)
        else:
            g = dy if ctx.op == "sum" else (dy.float() / w).to(dy.dtype)
            dx = sliding_pool.sum_pool_bwd(g, window=w)
        return dx.to(dy.dtype), None, None, None


# max-pool method crossover (the reference's, measured on its BENCH pool
# rows): shift-and-max (lower constant) below, the two-phase block scan
# (O(n), window-independent) from here up
POOL_SHIFT_MAX_WINDOW = 32


def _pool_method(x, window: int, op: str, explicit: str | None) -> str:
    """explicit argument → heuristic. The reference consults its tuned
    cache (``autotune_pool1d``'s entry under ``pool1d_key``) between the
    two; the port has no tuning cache yet, and with an empty cache the
    reference resolves as this does: sum/avg always "scan", max "shift"
    below ``POOL_SHIFT_MAX_WINDOW`` and "scan" from it up."""
    if explicit is not None:
        return explicit
    if op != "max":
        return "scan"
    return "shift" if window < POOL_SHIFT_MAX_WINDOW else "scan"


def pool1d(x: torch.Tensor, *, window: int, op: str = "sum",
           method: str | None = None) -> torch.Tensor:
    """VALID sliding pooling along axis 1. x: (B, L, C) -> (B, L-w+1, C),
    op "sum", "avg" or "max". A call whose input needs a gradient goes
    through ``Pool1d``. ``method`` picks the max-pool forward evaluation
    ("scan" | "shift"); None resolves it by ``_pool_method``."""
    resolved = _pool_method(x, window, op, method)
    key = autotune.pool1d_key(*x.shape, window, op, _dtype_name(x))
    POOL1D_DISPATCH[key] = "cuda" if x.device.type == "cuda" else "plain"

    def run():
        if _needs_grad(x):
            return Pool1d.apply(x, window, op, resolved)
        return sliding_pool.sliding_pool(x, window=window, op=op,
                                         method=resolved)

    return _dispatch("pool1d", key, (x,), run)
