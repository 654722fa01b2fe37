"""Convolution by sliding-window evaluation, in plain torch.

The ``sliding`` backend of ``repro.core.conv``: every filter tap adds one
(Cin × Cout) matrix product over a shifted slice of the unmodified input,
so no im2col buffer is built. Layout NLC (batch, length, channels);
weights (K, Cin, Cout), or (K, C) for the depthwise conv, where each tap is
one shifted elementwise multiply-add. This is the backend that runs when the model asks
for ``conv_backend="sliding"``; the CUDA kernel is reached through
``repro_torch.kernels.ops.conv1d`` (``sliding_pallas``). Beside it, as in
the reference, ``conv1d_im2col`` (the (B, out, K·Cin) column tensor, then
one product) and ``conv1d_xla`` (``torch.nn.functional.conv1d``), behind
the ``conv1d`` dispatcher; each takes ``groups``.

The 2-D twins (layout NHWC, weights HWIO) are the same three backends as
the reference's: ``conv2d_sliding`` (kh·kw shifted matrix products),
``conv2d_im2col`` (the column tensor, then one product) and ``conv2d_xla``
(``torch.nn.functional.conv2d``), behind ``conv2d``. The 2-D
CUDA kernel is reached through ``repro_torch.kernels.ops.conv2d``.
"""
from __future__ import annotations

import math

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


def _check_groups(Cin: int, Cin_g: int, Cout: int, groups: int) -> None:
    if Cin_g * groups != Cin:
        raise ValueError(f"groups mismatch: {Cin_g}*{groups} != {Cin}")
    if Cout % groups:
        raise ValueError("Cout must be divisible by groups")


def conv1d_sliding(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding="VALID",
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Sliding-window 1-D convolution. x: (B, L, Cin), w: (K, Cin//groups,
    Cout).

    y[b, i, co] = sum_k sum_ci w[k, ci, co] * x[b, i*stride + k*dilation, ci]

    (ci over the input channels of co's group.) Accumulates in float32 (or
    wider), in place (no tap's sum outlives the next), and casts back to
    ``x.dtype``.
    """
    B, L, Cin = x.shape
    K, Cin_g, Cout = w.shape
    _check_groups(Cin, Cin_g, Cout, groups)
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
        if groups == 1:
            acc += xs @ wa[k]
        else:
            # the reference's grouping of w[k]'s (Cin//groups, Cout)
            # storage (see ``conv1d``)
            wk = wa[k].reshape(groups, Cin_g, Cout // groups)
            acc += torch.einsum(
                "blgc,gcd->blgd", xs.reshape(B, out_len, groups, Cin_g),
                wk).reshape(B, out_len, Cout)
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


def conv1d_im2col(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding="VALID",
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Baseline: the (B, out_len, K·Cin) column tensor, then one product,
    summed in float32 (or wider), cast back to ``x.dtype``."""
    B, L, Cin = x.shape
    K, Cin_g, Cout = w.shape
    _check_groups(Cin, Cin_g, Cout, groups)
    lo, hi = _resolve_pad_1d(padding, K, dilation)
    if lo or hi:
        x = F.pad(x, (0, 0, lo, hi))
    out_len = _out_len(L, K, stride, dilation, lo, hi)
    span = (out_len - 1) * stride + 1
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    # (B, out, K, Cin): the K-fold bloated buffer
    col = torch.stack([x[:, k * dilation : k * dilation + span : stride]
                       for k in range(K)], dim=2).to(acc_dtype)
    wa = w.to(acc_dtype)
    if groups == 1:
        y = torch.einsum("blkc,kcd->bld", col, wa)
    else:
        col = col.reshape(B, out_len, K, groups, Cin_g)
        wg = wa.reshape(K, groups, Cin_g, Cout // groups)
        y = torch.einsum("blkgc,kgcd->blgd", col, wg).reshape(B, out_len, Cout)
    return y.to(x.dtype)


def conv1d_xla(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding="VALID",
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """The library convolution: ``torch.nn.functional.conv1d`` (cuDNN on
    the card, in full float32 once ``repro_torch.resolve_device`` has
    turned TF32 off) in NLC / (K, Cin//groups, Cout), output in
    ``x.dtype``."""
    lo, hi = _resolve_pad_1d(padding, w.shape[0], dilation)
    if lo or hi:
        x = F.pad(x, (0, 0, lo, hi))
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype).permute(2, 1, 0),
                 stride=stride, dilation=dilation, groups=groups)
    return y.transpose(1, 2).to(x.dtype)


def conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding="VALID",
    dilation: int = 1,
    groups: int = 1,
    backend: str = "sliding",
) -> torch.Tensor:
    """Dispatching 1-D convolution: ``sliding``, ``im2col_gemm`` or
    ``xla``.

    With ``groups`` > 1 and more than one input channel a group, the
    ``sliding`` and ``im2col_gemm`` twins read group g's weights as the
    reference's twins do, from the reshape of each tap's (Cin//groups,
    Cout) storage to (groups, Cin//groups, Cout//groups); ``xla`` takes
    output channel co from w[:, :, co], as ``lax.conv_general_dilated``
    does. The two agree only for one input channel a group (depthwise)."""
    fn = {
        "sliding": conv1d_sliding,
        "im2col_gemm": conv1d_im2col,
        "xla": conv1d_xla,
    }[backend]
    return fn(x, w, stride=stride, padding=padding, dilation=dilation,
              groups=groups)


# ---------------------------------------------------------------------------
# 2-D convolution
# ---------------------------------------------------------------------------

def _resolve_pad_2d(padding, kh: int, kw: int, dil) -> tuple:
    if isinstance(padding, str):
        return (_resolve_pad_1d(padding, kh, dil[0]),
                _resolve_pad_1d(padding, kw, dil[1]))
    (a, b), (c, d) = padding
    return ((int(a), int(b)), (int(c), int(d)))


def _pad_2d(x: torch.Tensor, pads) -> torch.Tensor:
    (plo_h, phi_h), (plo_w, phi_w) = pads
    if plo_h or phi_h or plo_w or phi_w:
        x = F.pad(x, (0, 0, plo_w, phi_w, plo_h, phi_h))
    return x


def _shifted_views(x, kh, kw, oh, ow, stride, dilation):
    """The kh·kw shifted (B, oh, ow, Cin) views of a padded input, tap
    (i, j) at row i·dh and column j·dw, strided."""
    span_h = (oh - 1) * stride[0] + 1
    span_w = (ow - 1) * stride[1] + 1
    for i in range(kh):
        for j in range(kw):
            r, c = i * dilation[0], j * dilation[1]
            yield x[:, r : r + span_h : stride[0], c : c + span_w : stride[1]]


def _out_hw(x, kh, kw, stride, dilation, pads):
    (plo_h, phi_h), (plo_w, phi_w) = pads
    return (_out_len(x.shape[1], kh, stride[0], dilation[0], plo_h, phi_h),
            _out_len(x.shape[2], kw, stride[1], dilation[1], plo_w, phi_w))


def conv2d_sliding(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: tuple[int, int] = (1, 1),
    padding="VALID",
    dilation: tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Sliding-window 2-D convolution. x: (B, H, W, Cin), w: (kh, kw, Cin,
    Cout). The tap loop runs over kh·kw shifted views of the input, each
    one (Cin × Cout) matrix product; the im2col buffer (kh·kw times the
    input) is never formed. Sums in float32 (or wider), cast back to
    ``x.dtype``."""
    kh, kw, cin_w, cout = w.shape
    if cin_w != x.shape[3]:
        raise ValueError(f"Cin mismatch {cin_w} != {x.shape[3]}")
    pads = _resolve_pad_2d(padding, kh, kw, dilation)
    oh, ow = _out_hw(x, kh, kw, stride, dilation, pads)
    x = _pad_2d(x, pads)
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xa, wa = x.to(acc_dtype), w.to(acc_dtype)
    acc = torch.zeros((x.shape[0], oh, ow, cout), dtype=acc_dtype,
                      device=x.device)
    for t, xs in enumerate(_shifted_views(xa, kh, kw, oh, ow, stride,
                                          dilation)):
        acc += xs @ wa[t // kw, t % kw]
    return acc.to(x.dtype)


def conv2d_im2col(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: tuple[int, int] = (1, 1),
    padding="VALID",
    dilation: tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Baseline: the (B, oh, ow, kh·kw·Cin) column tensor, then one matrix
    product, summed in float32 (or wider)."""
    kh, kw, cin, cout = w.shape
    pads = _resolve_pad_2d(padding, kh, kw, dilation)
    oh, ow = _out_hw(x, kh, kw, stride, dilation, pads)
    x = _pad_2d(x, pads)
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    col = torch.stack(list(_shifted_views(x, kh, kw, oh, ow, stride,
                                          dilation)), dim=3)
    col = col.reshape(*col.shape[:3], kh * kw * cin).to(acc_dtype)
    y = col @ w.reshape(kh * kw * cin, cout).to(acc_dtype)
    return y.to(x.dtype)


def conv2d_xla(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: tuple[int, int] = (1, 1),
    padding="VALID",
    dilation: tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """The library convolution: ``torch.nn.functional.conv2d`` (cuDNN on
    the card, in full float32 once ``repro_torch.resolve_device`` has
    turned TF32 off) in NHWC / HWIO, output in ``x.dtype``."""
    pads = _resolve_pad_2d(padding, w.shape[0], w.shape[1], dilation)
    x = _pad_2d(x, pads)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 stride=tuple(stride), dilation=tuple(dilation))
    return y.permute(0, 2, 3, 1).to(x.dtype)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: tuple[int, int] = (1, 1),
    padding="VALID",
    dilation: tuple[int, int] = (1, 1),
    backend: str = "sliding",
) -> torch.Tensor:
    fn = {
        "sliding": conv2d_sliding,
        "im2col_gemm": conv2d_im2col,
        "xla": conv2d_xla,
    }[backend]
    return fn(x, w, stride=tuple(stride), padding=padding,
              dilation=tuple(dilation))


def conv_flops(batch, out_spatial, k_spatial, cin, cout) -> int:
    """2 × the multiply-adds of a convolution: the same for every backend
    (the paper's §2: the sliding convolution does as many arithmetic
    operations as the naive or GEMM-based algorithms)."""
    out = (math.prod(out_spatial) if isinstance(out_spatial, (tuple, list))
           else out_spatial)
    k = (math.prod(k_spatial) if isinstance(k_spatial, (tuple, list))
         else k_spatial)
    return 2 * batch * out * k * cin * cout
