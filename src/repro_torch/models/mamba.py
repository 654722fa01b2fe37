"""Mamba (selective SSM) block, the jamba hybrid's workhorse layer
(``repro.models.mamba``).

Paper-technique site: the causal depthwise conv1d (K = 4) inside every
Mamba block is a sliding-window convolution. It routes through
``cfg.conv_backend``:

  * ``sliding_pallas``: one launch of the depthwise CUDA kernel
    (``kernels.ops.conv1d_depthwise``), bias and silu fused; with
    ``cfg.conv_precision == "w8a8"`` and an int8 ``conv_w`` leaf, one
    launch of the int8 depthwise kernel on int8 activations;
  * ``sliding``: ``core.conv.conv1d_depthwise_sliding``, the same
    shift-and-multiply-add in plain torch, epilogue unfused;
  * ``xla``: ``torch.nn.functional.conv1d`` with ``groups=C``, unfused.

The prefill conv runs over the whole prompt; the decode step's window conv
(K rows of state times K taps) is an elementwise product in plain torch,
as in the reference.

Selective scan: chunks of ``SSM_CHUNK`` positions in order, the (B,
d_inner, N) state carried across; inside a chunk the recurrence ``h_t =
abar_t h_{t-1} + bx_t`` runs as the reference's associative scan (the same
odd/even recursion as ``jax.lax.associative_scan``), so the (B, c,
d_inner, N) float32 working set exists for one chunk at a time. In
training each chunk step runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of its scan step) and is recomputed in
backward from its carried state.

Training through ``sliding_pallas``: the conv goes through
``ops.Conv1dDepthwise``, so a step runs the forward depthwise kernel with
the saved pre-activation, dx through the same kernel and dw and db through
the depthwise dw kernel.

The activation scale of an int8 conv is the leaf's calibrated ``x_scale``
when it has one, else the dynamic absmax of each call. The conv sites are
not observed by the calibration: in the reference they run under the
period ``lax.scan`` of ``models.jamba``, where the observation sees
tracers and records nothing, so every mamba conv serves with a dynamic
scale; the port does the same.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import conv as core_conv
from repro_torch.distributed.sharding import ParamDef
from repro_torch.kernels import ops
from repro_torch.quant.qconv import QuantizedWeight, conv1d_depthwise_q

SSM_CHUNK = 256


def mamba_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, di = cfg.d_model, cfg.mamba_d_inner
    N, K, R = cfg.mamba_d_state, cfg.mamba_conv_k, cfg.resolved_dt_rank
    return {
        "in_proj": ParamDef((d, 2 * di), ("embed", "conv_inner"), init="fan_in"),
        "conv_w": ParamDef((K, di), (None, "conv_inner"), init="fan_in"),
        "conv_b": ParamDef((di,), ("conv_inner",), init="zeros"),
        "x_proj": ParamDef((di, R + 2 * N), ("conv_inner", None), init="fan_in"),
        "dt_proj": ParamDef((R, di), (None, "conv_inner"), init="fan_in"),
        "dt_bias": ParamDef((di,), ("conv_inner",), init="small", dtype="float32"),
        "A_log": ParamDef((di, N), ("conv_inner", None), init="small",
                          dtype="float32", scale=0.5),
        "D": ParamDef((di,), ("conv_inner",), init="ones", dtype="float32"),
        "out_proj": ParamDef((di, d), ("conv_inner", "embed"), init="fan_in"),
    }


def _resolve_conv_w(p, dt) -> torch.Tensor:
    """The depthwise conv weight in ``dt``, dequantized from an int8 leaf."""
    w = p["conv_w"]
    if isinstance(w, QuantizedWeight):
        return w.dequant(dt)
    return w.to(dt)


def _conv_act(x: torch.Tensor, w, b: torch.Tensor, cfg: ModelConfig):
    """Causal depthwise conv -> bias -> silu over the prompt. x: (B, L, C)."""
    backend = cfg.conv_backend
    if isinstance(w, QuantizedWeight) and cfg.conv_precision == "w8a8":
        if backend == "sliding_pallas":
            return ops.conv1d_depthwise(
                x, w.q, padding="CAUSAL", bias=b, activation="silu",
                precision="w8a8", w_scale=w.scale, x_scale=w.x_scale)
        return conv1d_depthwise_q(
            x, w, b, mode="w8a8", x_scale=w.x_scale, padding="CAUSAL",
            activation="silu", accumulate="fast", out_dtype=x.dtype)
    # weight-only int8 leaves dequantize as weights
    w = w.dequant(x.dtype) if isinstance(w, QuantizedWeight) else w.to(x.dtype)
    if backend == "sliding_pallas":
        return ops.conv1d_depthwise(x, w, padding="CAUSAL", bias=b,
                                    activation="silu")
    if backend == "sliding":
        y = core_conv.conv1d_depthwise_sliding(x, w, padding="CAUSAL")
    elif backend == "xla":
        K, C = w.shape
        y = F.conv1d(F.pad(x, (0, 0, K - 1, 0)).transpose(1, 2),
                     w.t()[:, None, :], groups=C).transpose(1, 2)
    else:
        raise ValueError(f"unknown conv backend {backend!r}")
    return F.silu(y + b.to(y.dtype))


def _combine(left, right):
    """The linear recurrence's composition: (al, bl) then (ar, br)."""
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Positions 0, 2, 4, … from ``even`` and 1, 3, … from ``odd`` along
    dim 1."""
    n = even.shape[1] + odd.shape[1]
    out = torch.empty((even.shape[0], n, *even.shape[2:]), dtype=even.dtype,
                      device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``_combine`` along dim 1, by the odd/even
    recursion of ``jax.lax.associative_scan`` (the same pairs combined in
    the same order): log-depth, elementwise on whole tensors."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _assoc_scan(abar: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor):
    """h_t = abar_t * h_{t-1} + bx_t within a chunk. abar/bx: (B, c, D, N);
    h0: (B, D, N). Returns (h_all, h_last)."""
    a_cum, b_cum = _associative_scan(abar, bx)
    h_all = a_cum * h0[:, None] + b_cum
    return h_all, h_all[:, -1]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def mamba_apply(p, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None,
                return_state: bool = False):
    """x: (B, L, d_model). ``state`` (decode): {"conv": (B, K-1, di), "ssm":
    (B, di, N)}. Returns (y, new state or None); ``return_state`` (prefill)
    gives the final {"conv", "ssm"} state from a fresh start."""
    B, Lt, _ = x.shape
    di, N, K = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_conv_k
    dt_r = cfg.resolved_dt_rank
    dt = x.dtype
    xz = x @ p["in_proj"].to(dt)
    xin, z = xz.split(di, dim=-1)

    if state is None:
        xc = _conv_act(xin, p["conv_w"], p["conv_b"], cfg)
        new_conv = None
    else:
        hist = torch.cat([state["conv"].to(dt), xin], dim=1)  # (B, K, di)
        w = _resolve_conv_w(p, dt)
        xc = (hist * w[None]).sum(dim=1, keepdim=True) + p["conv_b"].to(dt)
        new_conv = hist[:, 1:]
        xc = F.silu(xc)

    A = -torch.exp(p["A_log"])  # (di, N) float32

    def ssm_params(xc_blk):
        xdbc = xc_blk @ p["x_proj"].to(dt)
        dtr, Bp, Cp = xdbc.split([dt_r, N, N], dim=-1)
        delta = _softplus(dtr.float() @ p["dt_proj"].float() + p["dt_bias"])
        abar = torch.exp(delta[..., None] * A[None, None])  # (B, c, di, N)
        bx = (delta * xc_blk.float())[..., None] * Bp.float()[:, :, None, :]
        return abar, bx, Cp

    def read_out(h_all, Cp):
        """einsum("blcn,bln->blc") in dt: one batched product."""
        Bb, c = h_all.shape[:2]
        y = torch.bmm(h_all.to(dt).reshape(Bb * c, di, N),
                      Cp.reshape(Bb * c, N, 1))
        return y.reshape(Bb, c, di)

    def chunk_step(h, xc_blk):
        abar, bx, Cp = ssm_params(xc_blk)
        h_all, h_last = _assoc_scan(abar, bx, h)
        return h_last, read_out(h_all, Cp)

    if state is None:
        c = min(SSM_CHUNK, Lt)
        n = -(-Lt // c)
        # a ragged tail pads with zero rows, trimmed from the output; as in
        # the reference, the final state has run through the padded rows
        xc_p = F.pad(xc, (0, 0, 0, n * c - Lt)) if n * c > Lt else xc
        h = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
        # training: each chunk step is recomputed in backward from its
        # carried state (the reference's jax.checkpoint of ``step``), so
        # autograd keeps one chunk's scan tensors at a time, not every
        # chunk's
        ckpt = torch.is_grad_enabled()
        ys = []
        for i in range(n):
            blk = xc_p[:, i * c : (i + 1) * c]
            h, y_blk = (checkpoint(chunk_step, h, blk, use_reentrant=False)
                        if ckpt else chunk_step(h, blk))
            ys.append(y_blk)
        y = torch.cat(ys, dim=1)[:, :Lt]
        h_last = h
    else:
        abar, bx, Cp = ssm_params(xc)
        h = abar[:, 0] * state["ssm"] + bx[:, 0]  # one decode step
        new_ssm = h
        y = read_out(h[:, None], Cp)
    y = y + xc * p["D"].to(dt)
    y = y * F.silu(z)
    out = y @ p["out_proj"].to(dt)
    if state is not None:
        return out, {"conv": new_conv.to(state["conv"].dtype), "ssm": new_ssm}
    if return_state:
        return out, {"conv": xin[:, -(K - 1):], "ssm": h_last}
    return out, None


def mamba_state_defs(cfg: ModelConfig, n_layers: int, batch: int):
    di, N, K = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_conv_k
    return {
        "conv": ParamDef(
            (n_layers, batch, K - 1, di),
            ("layers", "batch", None, "conv_inner"), init="zeros",
        ),
        "ssm": ParamDef(
            (n_layers, batch, di, N),
            ("layers", "batch", "conv_inner", None), init="zeros",
            dtype="float32",
        ),
    }
