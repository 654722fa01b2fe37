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

Every kernel entry runs through a graceful-degradation ladder
(``_ladder``), the reference's, at the reference's eight sites
(``conv1d``, ``conv1d.<precision>``, ``conv1d_depthwise``,
``conv1d_depthwise.<precision>``, ``conv2d``, ``conv2d.<precision>``,
``attention_decode``, ``pool1d``). On a CUDA tensor its rungs are
``cuda`` (the kernel), ``plain`` (the reference's compiled-JAX rung in
plain torch: the ``core.conv`` sliding twins with an unfused epilogue, the
fast-accumulating ``qconv`` int8 products, ``attention_decode_plain``,
``core.sliding.pool_ref``) and ``ref`` (the library oracles:
``torch.nn.functional`` convs, the exact int8 products,
``attention_decode_ref``; ``pool1d`` has two rungs). On a CPU tensor the
kernel wrapper runs its plain version as the top rung, named ``plain``,
and ``ref`` follows. A rung is demoted only by an injected fault
(``faults.maybe_fail_rung``: ``pallas_compile`` at ``cuda``,
``jax_runtime`` at ``plain``), with a reason-coded ``HEALTH`` event
(``demote:cuda->plain``) and a circuit breaker that re-admits the rung
through one probation call after its cooldown. Every other exception of a
rung (a build, launch or CUDA error, ``PlanError``, a shape error)
propagates unchanged, with no event and no next rung: a CUDA fault is
sticky for its process context, so serving a real one from another rung
would hide it. A kernel that fails at run time surfaces at the caller's
next synchronise: ``faults.guest_trap`` records the trip (armed by a
runtime injection or ``REPRO_RUNTIME_SENTINEL``) and
``faults.raise_pending`` raises it. Serve's and train's catch layers
demote the rung and re-run on an injected trip; a trip of the sentinel (a
rung's own non-finite output) is recorded and fails the request or step,
with no demotion. Nothing armed and no breaker open, a CUDA tensor goes
to its kernel and a CPU tensor to the plain version, as before: the
ladder then costs two flag checks.

Each kernel entry resolves its launch plan as the reference resolves its
tiles: an explicit ``plan`` (``bwd_plan`` for a weight gradient) → the
tuned entry under its shape key in the port's tuning cache
(``autotune.lookup``; the ``grad=True`` key for the weight gradients, the
dx conv's own key for dx) → None, the plan functions' rule. With no cache
every launch runs the rule. A tuned entry the plan function refuses
raises, naming its key. The plain versions take no plan. A float-input
``conv1d(precision=...)`` serves the float path instead where both its
quant key and its float key hold timings and the quant one is slower
(``_quant_fallback_reason``, logged in ``_QUANT_FALLBACKS`` with one
``quant_slower`` health event a key), unless pinned to the quant kernel
by int8 input, a fused requant or an explicit plan, as in the reference.

Each entry records its dispatch at the rung that serves it (``_dispatch``),
as the reference's ``_ladder`` does: when tracing or
``obs.enable_dispatch`` is armed, the rung's call runs in a
``kernel.dispatch`` span and adds to ``dispatch.calls``,
``dispatch.seconds_total`` and ``dispatch.est_hbm_bytes_total`` under its
autotune shape key and its rung, and the entry's dispatch log
(``ATTN_DECODE_DISPATCH``, ``CONV2D_DISPATCH``, ...) names that rung.
The reference dispatches at trace time, so its seconds are trace cost and
its calls count traces; here every eager call passes through, and on the
card the seconds are host launch time (nothing synchronises inside the
span). Disarmed, the path is one flag check.
"""
from __future__ import annotations

import sys
import time

import torch
import torch.nn.functional as F

from repro_torch import faults
from repro_torch.core import conv as core_conv
from repro_torch.core.sliding import pool_ref
from repro_torch.health import HEALTH, canon_reason
from repro_torch.kernels import attention_decode as attn_dec
from repro_torch.kernels import (
    autotune, gemm_plan, im2col_gemm, sliding_conv1d, sliding_conv2d,
    sliding_conv_bwd, sliding_conv_quant, sliding_pool,
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
# shape key → reason for shapes where the quant path measurably loses to
# the float path and dispatch served the float one; named, as the
# reference's, so the fallback record lands in metrics.json
_QUANT_FALLBACKS = DispatchLog("quant_fallback")


def _dtype_name(t: torch.Tensor) -> str:
    """The dtype field of a shape key: "float32", "bfloat16", ..."""
    return str(t.dtype).removeprefix("torch.")


def _nbytes(*ts) -> int:
    """Bytes of the tensors among ``ts``, each counted once (the
    reference's ``est_hbm_bytes`` over operands and result)."""
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _dispatch(site: str, key: str, operands: tuple, run, rung=None):
    """One rung's call, ``run()``. Disarmed (neither tracing nor the
    dispatch metrics on) that is all it does. Armed, the call runs in a
    ``kernel.dispatch`` span (site, key, rung) and is counted in
    ``dispatch.calls``, ``dispatch.seconds_total`` and
    ``dispatch.est_hbm_bytes_total`` (``operands`` and the result) under
    its autotune shape ``key``; ``rung`` defaults to ``cuda`` for a CUDA
    tensor and ``plain`` for a CPU one. No synchronise: on the card the
    seconds are the host's launch time."""
    if not (obs_trace.TRACING or obs_metrics.DISPATCH_ON):
        return run()
    if rung is None:
        rung = "cuda" if operands[0].device.type == "cuda" else "plain"
    t0 = time.perf_counter()
    with obs_trace.span("kernel.dispatch", site=site, key=key, rung=rung):
        out = run()
    dt = time.perf_counter() - t0
    obs_metrics.count_dispatch(dt, float(_nbytes(*operands, out)),
                               site=site, key=key, rung=rung)
    return out


def _on_card(t: torch.Tensor) -> bool:
    """Does the ladder start at the kernel? For a CUDA tensor."""
    return t.is_cuda


def _ladder(site: str, kernel, lower, *, key: str, operands: tuple,
            log: DispatchLog | None = None):
    """The graceful-degradation dispatch of one call (the reference's
    ``_ladder``). ``kernel`` is the top rung's thunk: the kernel on a CUDA
    tensor (rung ``cuda``), the wrapper's plain version on a CPU one (rung
    ``plain``). ``lower()`` gives the rungs below the kernel as (name,
    thunk) pairs, ``plain`` then ``ref``; it is called only when a fault is
    armed or a breaker is open, and on a CPU tensor its ``plain`` pair is
    dropped (the top rung is the plain version there).

    Rungs whose breaker is open are skipped (a fully demoted site keeps its
    last rung). ``faults.maybe_fail_rung`` fires before each rung: its
    ``FaultError`` demotes the rung with a ``demote:<rung>-><next>``
    event, and the next rung serves; at the last rung it propagates. Any
    other exception of a rung propagates unchanged, with no event and no
    next rung. The serving rung's output passes ``faults.guest_trap`` (a
    runtime trip or the sentinel's flag, surfaced later by
    ``faults.raise_pending``), credits ``HEALTH.note_success`` (which also
    repromotes a probing rung) and is logged in ``log`` under ``key``."""
    top = "cuda" if _on_card(operands[0]) else "plain"
    if not (faults.ARMED or HEALTH.has_breakers):
        if log is not None:
            log[key] = top
        return _dispatch(site, key, operands, kernel, top)
    rungs = [(top, kernel)] + [r for r in lower()
                               if top == "cuda" or r[0] != "plain"]
    live = [r for r in rungs if not HEALTH.is_demoted(site, r[0])]
    live = live or rungs[-1:]
    for i, (name, thunk) in enumerate(live):
        try:
            faults.maybe_fail_rung(name, site)
        except faults.FaultError as e:
            if i + 1 == len(live):
                raise
            reason = canon_reason(e)
            HEALTH.record(site, reason, f"demote:{name}->{live[i + 1][0]}",
                          detail=repr(e)[:200])
            HEALTH.demote(site, name, reason=reason)
            continue
        if log is not None:
            log[key] = name
        out = _dispatch(site, key, operands, thunk, name)
        faults.guest_trap(site, name, key, out)
        HEALTH.note_success(site, name)
        return out
    raise AssertionError("unreachable")


def _resolve(key: str, explicit: dict | None) -> dict | None:
    """The plan a launch runs: the explicit one, else the tuned entry
    under ``key``, else None (the plan function's rule)."""
    return explicit if explicit is not None else autotune.lookup(key)


def _planned(key: str, plan: dict | None, fn, *args, **kwargs):
    """``fn(*args, plan=plan, **kwargs)``; a plan the launch refuses raises
    ``PlanError`` naming the shape key it came under."""
    try:
        return fn(*args, plan=plan, **kwargs)
    except gemm_plan.PlanError as e:
        if plan is None:
            raise
        raise gemm_plan.PlanError(f"plan {plan} under {key}: {e}") from e


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


def _quant_fallback_reason(x, w, stride, precision) -> str | None:
    """Measured-regression guard of the quant 1-D dispatch (the
    reference's): where the tuning cache holds timings for both this
    shape's quant path and its float path and the float one is faster,
    the reason to serve the float path (logged once a key in
    ``_QUANT_FALLBACKS``, with a ``quant_slower`` health event); else
    None. The caller applies it only to float input with no fused
    requant and no explicit plan. The quant side's time is its entry's
    ``dispatch_us`` where the search recorded one (the winner through a
    float-input call here, which also quantizes x and reads its scales
    back to the host), else its kernel ``us``: the reference compares
    the kernel's alone, which can serve a quant path several times slower
    end to end."""
    B, L, Cin = x.shape
    K, _, Cout = w.shape
    kq = autotune.conv1d_key(B, L, Cin, Cout, K, stride, precision)
    kf = autotune.conv1d_key(B, L, Cin, Cout, K, stride, _dtype_name(x))
    tq, tf = autotune.lookup(kq), autotune.lookup(kf)
    if not (tq and tf):
        return None
    us_q, us_f = tq.get("dispatch_us", tq.get("us")), tf.get("us")
    if us_q is None or us_f is None or us_q <= us_f:
        return None
    reason = (f"tuned {precision} path {us_q:.0f}us > {_dtype_name(x)} "
              f"{us_f:.0f}us for {kq}; serving the float path")
    first = kq not in _QUANT_FALLBACKS
    _QUANT_FALLBACKS[kq] = reason  # repeat hits bump the per-key count
    if first:
        print(f"[quant] fallback: {reason}", file=sys.stderr)
        HEALTH.record(f"conv1d.{precision}", "quant_slower", "fallback:fp",
                      detail=kq)
    return reason


def _conv1d_quant(x, w, *, stride, padding, dilation, backend, bias,
                  activation, precision, w_scale, x_scale, out_scale, plan):
    """The quantized branch of ``conv1d``: pad (an int8 input with code 0),
    screen the scales, serve the float path where the tuned timings say
    it is faster (``_quant_fallback_reason``), quantize the float
    operands, then the int8 kernel on its plan."""
    _check_quant_dispatch(precision, backend)
    if dilation != 1:
        raise ValueError("quantized convs cover dilation == 1 only")
    x = _pad1d(x, padding, w.shape[0])
    site = f"conv1d.{precision}"
    x_scale, to_float = _guard_quant_scales(site, x, w, w_scale, x_scale)
    if to_float:  # unusable calibrated scale, float operands: the fp path
        return conv1d(x, w, stride=stride, backend=backend, bias=bias,
                      activation=activation)
    if (x.dtype != torch.int8 and out_scale is None and plan is None
            and _quant_fallback_reason(x, w, stride, precision) is not None):
        # measured regression: the float sliding path. Pinned to the quant
        # kernel regardless: int8 inputs and a fused requant (a chained
        # site keeps its int8 contract), and an explicit plan (the tuner
        # times the plan it asked for)
        wf = w
        if w.dtype == torch.int8:
            if w_scale is None:
                raise ValueError("int8 weights need their w_scale")
            wf = (w.float() * w_scale.float()).to(x.dtype)
        return conv1d(x, wf, stride=stride, backend=backend, bias=bias,
                      activation=activation)
    x, w, w_scale, x_scale, out_dtype = _quant_operands(
        x, w, w_scale, x_scale, precision)
    key = autotune.conv1d_key(*x.shape, w.shape[2], w.shape[0], stride,
                              precision)
    qplan = _resolve(key, plan)

    def q_plain(accumulate):
        return qconv.conv1d_q(
            x, qconv.QuantizedWeight(w, w_scale), bias, mode=precision,
            x_scale=x_scale, out_scale=out_scale, stride=stride,
            activation=activation, accumulate=accumulate,
            out_dtype=out_dtype)

    return _ladder(
        site,
        lambda: _planned(
            key, qplan, sliding_conv_quant.conv1d_quant,
            x, w, w_scale, bias, x_scale=x_scale, out_scale=out_scale,
            mode=precision, stride=stride, activation=activation,
            out_dtype=out_dtype),
        lambda: [("plain", lambda: q_plain("fast")),
                 ("ref", lambda: q_plain("int32"))],
        key=key, operands=(x, w, bias, w_scale, x_scale, out_scale))


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
    on the dilated gradient and the flipped weights (its plan from the
    cache under the dx conv's own key); dw and db through the dw kernel
    on the weight gradient's plan, cast to w's and bias's types. Grads
    nobody asked for are not computed. CPU tensors run the kernels' plain
    versions. ``plans``: (key, plan, grad key, weight-gradient plan)."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, activation, plans):
        key, plan, bwd_key, bwd_plan = plans
        if activation in (None, "none"):
            y = _planned(key, plan, sliding_conv1d.conv1d_sliding, x, w,
                         bias, stride=stride)
            z = None
        else:
            y, z = _planned(key, plan, sliding_conv1d.conv1d_sliding, x, w,
                            bias, stride=stride, activation=activation,
                            save_preact=True)
        ctx.save_for_backward(x, w, bias, z)
        ctx.stride, ctx.activation = stride, activation
        ctx.bwd = (bwd_key, bwd_plan)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, bias, z = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dz = sliding_conv_bwd.act_bwd(dy, z, ctx.activation).to(x.dtype)
        dx = dw = db = None
        if need_x:
            B, Lout, Cout = dz.shape
            K, Cin = w.shape[:2]
            dkey = autotune.conv1d_key(B, (Lout - 1) * ctx.stride + 2 * K - 1,
                                       Cout, Cin, K, 1, _dtype_name(dz))
            dx = _planned(dkey, autotune.lookup(dkey),
                          sliding_conv_bwd.conv1d_dx, dz, w,
                          stride=ctx.stride, L=x.shape[1])
        if need_w or need_b:
            dw, db = _planned(*ctx.bwd, sliding_conv_bwd.conv1d_bwd_dw,
                              x, dz, w.shape[0], stride=ctx.stride,
                              has_bias=bias is not None)
            dw = dw.to(w.dtype)
            db = None if db is None else db.to(bias.dtype)
        return dx, dw, db, None, None, None


class Conv1dDepthwise(torch.autograd.Function):
    """VALID depthwise conv1d + bias + activation with its backward on the
    kernels, as ``Conv1dSliding``: forward saves (x, w, bias, z), z the
    depthwise kernel's post-bias pre-activation (none with activation
    "none"). Backward: ``dz = act'(z) · dy`` in x's type; dx through the
    forward depthwise kernel on the dilated gradient and the flipped taps;
    dw and db through the depthwise dw kernel, cast to w's and bias's
    types. Grads nobody asked for are not computed. CPU tensors run the
    kernels' plain versions. One plan (``key``'s entry) serves all three:
    its ``rows`` and ``stages`` the forward and the dx conv (as the
    reference's entry gives its depthwise backward the forward's tile),
    its ``bwd_rows``, ``bwd_stages`` and ``bwd_splits`` the dw kernel."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, activation, key, plan):
        if activation in (None, "none"):
            y = _planned(key, plan, sliding_conv1d.conv1d_depthwise, x, w,
                         bias, stride=stride)
            z = None
        else:
            y, z = _planned(key, plan, sliding_conv1d.conv1d_depthwise, x, w,
                            bias, stride=stride, activation=activation,
                            save_preact=True)
        ctx.save_for_backward(x, w, bias, z)
        ctx.stride, ctx.activation = stride, activation
        ctx.key, ctx.plan = key, plan
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, bias, z = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dz = sliding_conv_bwd.act_bwd(dy, z, ctx.activation).to(x.dtype)
        dx = dw = db = None
        if need_x:
            dx = _planned(ctx.key, ctx.plan,
                          sliding_conv_bwd.conv1d_depthwise_dx, dz, w,
                          stride=ctx.stride, L=x.shape[1])
        if need_w or need_b:
            bwd = None if ctx.plan is None else {
                f: ctx.plan.get("bwd_" + f)
                for f in ("rows", "stages", "splits")}
            dw, db = _planned(ctx.key, bwd,
                              sliding_conv_bwd.conv1d_depthwise_bwd_dw,
                              x, dz, w.shape[0], stride=ctx.stride,
                              has_bias=bias is not None)
            dw = dw.to(w.dtype)
            db = None if db is None else db.to(bias.dtype)
        return dx, dw, db, None, None, None, None


class Conv2dSliding(torch.autograd.Function):
    """VALID sliding conv2d + bias + activation with its backward on the
    kernels, as ``Conv1dSliding``: forward saves (x, w, bias, z), z the
    2-D kernel's post-bias pre-activation (none with activation "none").
    Backward: ``dz = act'(z) · dy`` in x's type; dx through the forward 2-D
    kernel on the dilated gradient and the flipped, transposed weights; dw
    and db through the 2-D dw kernel, cast to w's and bias's types. Grads
    nobody asked for are not computed: an input that needs none (an image)
    costs no dx conv. CPU tensors run the kernels' plain versions. The
    plans as ``Conv1dSliding``'s: ``plans`` is (key, plan, grad key,
    weight-gradient plan), the dx conv's from its own key."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, activation, tiles, bwd_tiles,
                plans):
        key, plan, bwd_key, bwd_plan = plans
        if activation in (None, "none"):
            y = _planned(key, plan, sliding_conv2d.conv2d_sliding, x, w,
                         bias, stride=stride, **tiles)
            z = None
        else:
            y, z = _planned(key, plan, sliding_conv2d.conv2d_sliding, x, w,
                            bias, stride=stride, activation=activation,
                            save_preact=True, **tiles)
        ctx.save_for_backward(x, w, bias, z)
        ctx.stride, ctx.activation = stride, activation
        ctx.bwd_tiles, ctx.bwd = bwd_tiles, (bwd_key, bwd_plan)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, bias, z = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dz = sliding_conv_bwd.act_bwd(dy, z, ctx.activation).to(x.dtype)
        dx = dw = db = None
        if need_x:
            B, oh, ow, Cout = dz.shape
            kh, kw, Cin = w.shape[:3]
            sh, sw = ctx.stride
            dkey = autotune.conv2d_key(
                B, (oh - 1) * sh + 2 * kh - 1, (ow - 1) * sw + 2 * kw - 1,
                Cout, Cin, kh, kw, 1, 1, _dtype_name(dz))
            dx = _planned(dkey, autotune.lookup(dkey),
                          sliding_conv_bwd.conv2d_dx, dz, w,
                          stride=ctx.stride, H=x.shape[1], W=x.shape[2])
        if need_w or need_b:
            dw, db = _planned(*ctx.bwd, sliding_conv_bwd.conv2d_bwd_dw,
                              x, dz, w.shape[:2], stride=ctx.stride,
                              has_bias=bias is not None, **ctx.bwd_tiles)
            dw = dw.to(w.dtype)
            db = None if db is None else db.to(bias.dtype)
        return dx, dw, db, None, None, None, None, None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _conv1d_sliding(x, w, bias, stride, activation, backend, key, plan,
                    bwd_plan):
    """The sliding backends of ``conv1d`` on padded ``x``: the kernel (its
    plain version on a CPU tensor) for ``sliding_pallas``, and for
    ``sliding`` on a CUDA tensor; ``core.conv``'s tap loop with an unfused
    epilogue for ``sliding`` on a CPU tensor. ``plan`` under ``key`` as
    ``_resolve`` gave it; the weight gradient's from ``bwd_plan`` or the
    ``grad=True`` key (the reference's ``_bwd_tile1d``)."""
    if backend == "sliding" and x.device.type != "cuda":
        y = core_conv.conv1d_sliding(x, w, stride=stride, padding="VALID")
        return epilogue_unfused(y, bias, activation)
    if _needs_grad(x, w, bias):
        bwd_key = key + "|grad"
        return Conv1dSliding.apply(
            x, w, bias, stride, activation,
            (key, plan, bwd_key, _resolve(bwd_key, bwd_plan)))
    # nothing to differentiate (serving): the kernel saves no residual
    return _planned(key, plan, sliding_conv1d.conv1d_sliding, x, w, bias,
                    stride=stride, activation=activation)


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
    plan: dict | None = None,
    bwd_plan: dict | None = None,
) -> torch.Tensor:
    """Multi-channel 1-D convolution + bias + activation. x: (B, L, Cin),
    w: (K, Cin, Cout); padding VALID / SAME / CAUSAL / (lo, hi). The
    ``im2col_gemm`` and ``im2col_hbm`` baselines are forward only: a CUDA
    call whose inputs need a gradient raises.

    ``precision`` "w8a8" / "w8a16" selects the int8 kernel: ``w`` is int8
    with its per-Cout ``w_scale``, or float and quantized here; in w8a8 a
    float ``x`` is quantized onto ``x_scale`` (dynamic absmax when None),
    an int8 ``x`` comes with its ``x_scale``, and ``out_scale`` requantizes
    the output to int8 after the activation.

    ``plan`` (``tile``, ``splits``) forces the sliding kernel's launch
    plan and ``bwd_plan`` its weight gradient's; None takes the tuned
    entry under the shape key (the ``grad=True`` key for the gradient),
    else the rule."""
    if precision != "fp":
        return _conv1d_quant(
            x, w, stride=stride, padding=padding, dilation=dilation,
            backend=backend, bias=bias, activation=activation,
            precision=precision, w_scale=w_scale, x_scale=x_scale,
            out_scale=out_scale, plan=plan)
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
        key = autotune.conv1d_key(*x.shape, w.shape[2], w.shape[0], stride,
                                  _dtype_name(x))
        fplan = _resolve(key, plan)
        return _ladder(
            "conv1d",
            lambda: _conv1d_sliding(x, w, bias, stride, activation, backend,
                                    key, fplan, bwd_plan),
            lambda: [
                ("plain", lambda: epilogue_unfused(core_conv.conv1d_sliding(
                    x, w, stride=stride), bias, activation)),
                ("ref", lambda: epilogue_unfused(core_conv.conv1d_xla(
                    x, w, stride=stride), bias, activation))],
            key=key, operands=(x, w, bias))
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
    plan: dict | None = None,
) -> torch.Tensor:
    """Depthwise 1-D sliding conv + bias + activation in one launch (the
    mamba conv path). x: (B, L, C), w: (K, C); padding VALID / SAME /
    CAUSAL / (lo, hi). ``plan`` (``rows``, ``stages``; in floating point
    also row 11's ``bwd_rows``, ``bwd_stages``, ``bwd_splits``) forces
    the kernels' plans; None takes the tuned entry under the
    ``conv1d_dw_key``, else the rule.

    ``precision`` "w8a8" / "w8a16" runs the int8 depthwise kernel: ``w``
    is int8 with its per-channel ``w_scale`` ((C,) or (1, C)), or float and
    quantized here; in w8a8 a float ``x`` is quantized onto ``x_scale``
    (dynamic absmax when None) and ``out_scale`` requantizes the output.
    In floating point a call whose inputs need a gradient goes through
    ``Conv1dDepthwise``; the int8 path is inference only."""
    x = _pad1d(x, padding, w.shape[0])
    if precision == "fp":
        key = autotune.conv1d_dw_key(*x.shape, w.shape[0], stride,
                                     _dtype_name(x))
        dplan = _resolve(key, plan)

        def run():
            if _needs_grad(x, w, bias):
                return Conv1dDepthwise.apply(x, w, bias, stride, activation,
                                             key, dplan)
            # nothing to differentiate (serving): the kernel saves no residual
            return _planned(key, dplan, sliding_conv1d.conv1d_depthwise, x,
                            w, bias, stride=stride, activation=activation)

        return _ladder(
            "conv1d_depthwise", run,
            lambda: [
                ("plain", lambda: epilogue_unfused(
                    core_conv.conv1d_depthwise_sliding(
                        x, w, stride=stride, padding="VALID"),
                    bias, activation)),
                ("ref", lambda: epilogue_unfused(core_conv.conv1d_xla(
                    x, w[:, None, :], stride=stride, groups=x.shape[-1]),
                    bias, activation))],
            key=key, operands=(x, w, bias), log=CONV1D_DW_DISPATCH)
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
    qplan = _resolve(key, plan)

    def q_plain(accumulate):
        return qconv.conv1d_depthwise_q(
            x, qconv.QuantizedWeight(w, w_scale), bias, mode=precision,
            x_scale=x_scale, out_scale=out_scale, stride=stride,
            padding="VALID", activation=activation, accumulate=accumulate,
            out_dtype=out_dtype)

    return _ladder(
        site,
        lambda: _planned(
            key, qplan, sliding_conv_quant.conv1d_depthwise_quant,
            x, w, w_scale, bias, x_scale=x_scale, out_scale=out_scale,
            mode=precision, stride=stride, activation=activation,
            out_dtype=out_dtype),
        lambda: [("plain", lambda: q_plain("fast")),
                 ("ref", lambda: q_plain("int32"))],
        key=key, operands=(x, w, bias, w_scale, x_scale, out_scale),
        log=CONV1D_DW_DISPATCH)


def _bwd_tile2d(x, w, stride, explicit_h, explicit_w, explicit_plan):
    """The dw kernel's tiles (the explicit ones, else the defaults; the
    reference's tuned entry also carries tiles, the port's does not) and
    its plan under the ``grad=True`` key, resolved as ``_resolve`` does.
    Returns (tile_h, tile_w, key, plan); the key is logged in
    ``CONV2D_DISPATCH``."""
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    key = autotune.conv2d_key(B, H, W, Cin, Cout, kh, kw, *stride,
                              _dtype_name(x), grad=True)
    CONV2D_DISPATCH[key] = "cuda" if x.device.type == "cuda" else "plain"
    return (sliding_conv2d.DEFAULT_TILE_H if explicit_h is None else explicit_h,
            sliding_conv2d.DEFAULT_TILE_W if explicit_w is None else explicit_w,
            key, _resolve(key, explicit_plan))


def _conv2d_quant(x, w, *, stride, padding, dilation, backend, bias,
                  activation, tiles, precision, w_scale, x_scale, out_scale,
                  plan):
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
    qplan = _resolve(key, plan)

    def q_plain(accumulate):
        return qconv.conv2d_q(
            x, qconv.QuantizedWeight(w, w_scale), bias, mode=precision,
            x_scale=x_scale, out_scale=out_scale, stride=stride,
            activation=activation, accumulate=accumulate,
            out_dtype=out_dtype)

    return _ladder(
        site,
        lambda: _planned(
            key, qplan, sliding_conv_quant.conv2d_quant,
            x, w, w_scale, bias, x_scale=x_scale, out_scale=out_scale,
            mode=precision, stride=stride, activation=activation,
            out_dtype=out_dtype, **tiles),
        lambda: [("plain", lambda: q_plain("fast")),
                 ("ref", lambda: q_plain("int32"))],
        key=key, operands=(x, w, bias, w_scale, x_scale, out_scale),
        log=CONV2D_QUANT_DISPATCH)


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
    plan: dict | None = None,
    bwd_plan: dict | None = None,
) -> torch.Tensor:
    """Multi-channel 2-D convolution + bias + activation. x: (B, H, W, Cin),
    w: (kh, kw, Cin, Cout); padding VALID / SAME / ((lo, hi), (lo, hi)).

    The tiling arguments are the reference's; they are checked and do not
    change the result. ``plan`` (``tile``, ``splits``) forces the sliding
    kernel's launch plan and ``bwd_plan`` its weight gradient's; None
    takes the tuned entry under the shape key (the ``grad=True`` key for
    the gradient), else the rule. On the sliding backends a call whose inputs need a
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
            out_scale=out_scale, plan=plan)
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
    fplan = _resolve(key, plan)

    def run():
        if _needs_grad(x, w, bias):
            bth, btw, bwd_key, bplan = _bwd_tile2d(x, w, stride, bwd_tile_h,
                                                   bwd_tile_w, bwd_plan)
            bwd_tiles = dict(tile_h=bth, tile_w=btw, cin_block=cin_block,
                             cout_block=cout_block)
            return Conv2dSliding.apply(x, w, bias, stride, activation, tiles,
                                       bwd_tiles, (key, fplan, bwd_key, bplan))
        # nothing to differentiate (serving): the kernel saves no residual
        return _planned(key, fplan, sliding_conv2d.conv2d_sliding, x, w,
                        bias, stride=stride, activation=activation, **tiles)

    return _ladder(
        "conv2d", run,
        lambda: [
            ("plain", lambda: epilogue_unfused(core_conv.conv2d_sliding(
                x, w, stride=stride), bias, activation)),
            ("ref", lambda: epilogue_unfused(core_conv.conv2d_xla(
                x, w, stride=stride), bias, activation))],
        key=key, operands=(x, w, bias), log=CONV2D_DISPATCH)


def attention_decode(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    lengths: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    plan: dict | None = None,
) -> torch.Tensor:
    """Fused decode attention against the KV cache. q: (B, H, D) the new
    token's query heads; k/v: (B, S, KV, D), float rows, or int8 codes with
    their float32 ``k_scale``/``v_scale`` (B, S, KV, 1); lengths: (B,)
    int32 valid prefix per slot (decode: pos + 1; cross-attention: encoder
    lengths; 0 gives a zero row). GQA: H = KV * G. Returns (B, H, D)
    float32. ``plan`` (``split_rows``) forces the kernel's split length;
    None takes the tuned entry under the ``attn_dec|…`` key, else the
    rule (``attention_decode.decode_splits``)."""
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
    aplan = _resolve(key, plan)
    q4 = q.reshape(B, KV, G, D)
    out = _ladder(
        "attention_decode",
        lambda: _planned(key, aplan, attn_dec.decode_attention, q4, k, v,
                         lengths, k_scale, v_scale),
        lambda: [
            ("plain", lambda: attn_dec.attention_decode_plain(
                q4, k, v, lengths, k_scale, v_scale, block_s=S)),
            ("ref", lambda: attn_dec.attention_decode_ref(
                q4, k, v, lengths, k_scale, v_scale))],
        key=key, operands=(q, k, v, k_scale, v_scale),
        log=ATTN_DECODE_DISPATCH)
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
    """explicit argument → tuned cache entry (``autotune_pool1d``'s
    ``method`` under ``pool1d_key``) → heuristic, as the reference's:
    sum/avg always "scan", max "shift" below ``POOL_SHIFT_MAX_WINDOW``
    and "scan" from it up."""
    if explicit is not None:
        return explicit
    if op != "max":
        return "scan"
    B, L, C = x.shape
    tuned = autotune.lookup(autotune.pool1d_key(B, L, C, window, op,
                                                _dtype_name(x)))
    if tuned and tuned.get("method") in ("scan", "shift"):
        return tuned["method"]
    return "shift" if window < POOL_SHIFT_MAX_WINDOW else "scan"


def pool1d(x: torch.Tensor, *, window: int, op: str = "sum",
           method: str | None = None) -> torch.Tensor:
    """VALID sliding pooling along axis 1. x: (B, L, C) -> (B, L-w+1, C),
    op "sum", "avg" or "max". A call whose input needs a gradient goes
    through ``Pool1d``. ``method`` picks the max-pool forward evaluation
    ("scan" | "shift"); None resolves it by ``_pool_method``."""
    resolved = _pool_method(x, window, op, method)
    key = autotune.pool1d_key(*x.shape, window, op, _dtype_name(x))

    def run():
        if _needs_grad(x):
            return Pool1d.apply(x, window, op, resolved)
        return sliding_pool.sliding_pool(x, window=window, op=op,
                                         method=resolved)

    return _ladder(
        "pool1d", run,
        lambda: [("plain", lambda: pool_ref(x, window=window, op=op))],
        key=key, operands=(x,), log=POOL1D_DISPATCH)
