"""Sliding Window Sum primitives (Snytsar 2023, and companion arXiv:2305.16513),
in plain torch.

The paper's core observation: pooling and convolution are *sliding window
sums* — for window size ``w`` over a sequence ``x``::

    y[i] = reduce(x[i], x[i+1], ..., x[i+w-1])

and they can be evaluated either by

  * a **two-phase parallel scan** (prefix sums, then a strided difference) —
    O(n) work, no ``w``-times memory bloat, or
  * a **shift-and-accumulate** loop over the ``w`` taps, where each tap is a
    *whole-vector* shifted view of the unmodified input (the "vector slide").

Both avoid materializing the im2col matrix. This module is the plain layer
(the twin of ``repro.core.sliding``, function for function); the CUDA
pooling kernels in ``repro_torch.kernels.sliding_pool`` share its structure.
``pool_ref`` is the oracle of ``ops.pool1d`` (the reference's
``repro.kernels.ref.pool_ref``), kept here beside the functions it calls.
"""
from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor


def _check_window(window: int, n: int) -> None:
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if window > n:
        raise ValueError(f"window {window} exceeds length {n}")


# ---------------------------------------------------------------------------
# Sliding window sums (two-phase scan formulation)
# ---------------------------------------------------------------------------

def sliding_sum_scan(x: Tensor, window: int, axis: int = -1) -> Tensor:
    """Sliding window sum via the two-phase prefix-scan algorithm.

    Phase 1: inclusive prefix sum ``S`` along ``axis``, in float32 (float64
    stays float64) to bound cancellation over long sequences.
    Phase 2: ``y[i] = S[i + w - 1] - S[i - 1]`` — a strided difference.

    Output length along ``axis`` is ``n - window + 1`` (VALID windows
    only), cast back to x's type.
    """
    n = x.shape[axis]
    _check_window(window, n)
    acc = torch.promote_types(x.dtype, torch.float32)
    s = torch.cumsum(x.to(acc), dim=axis)
    upper = s.narrow(axis, window - 1, n - window + 1)
    lower = s.narrow(axis, 0, n - window + 1)
    head = upper.narrow(axis, 0, 1)
    body = upper.narrow(axis, 1, n - window) - lower.narrow(axis, 0, n - window)
    return torch.cat([head, body], dim=axis).to(x.dtype)


def sliding_sum_shift(x: Tensor, window: int, axis: int = -1) -> Tensor:
    """Sliding window sum via shift-and-accumulate (the vector-slide form):
    O(n * w) float32 adds, each tap a contiguous shifted read."""
    n = x.shape[axis]
    _check_window(window, n)
    out_len = n - window + 1
    acc = x.narrow(axis, 0, out_len).float()
    for k in range(1, window):
        acc = acc + x.narrow(axis, k, out_len).float()
    return acc.to(x.dtype)


def _log_scan(blocks: Tensor, op, reverse: bool = False) -> Tensor:
    """Inclusive scan of the associative ``op`` along the last dim by
    doubling (Hillis-Steele): log2(n) rounds of one shifted ``op``."""
    if reverse:
        return _log_scan(blocks.flip(-1), op).flip(-1)
    out = blocks
    n, d = blocks.shape[-1], 1
    while d < n:
        out = torch.cat([out[..., :d], op(out[..., d:], out[..., :-d])], dim=-1)
        d *= 2
    return out


def sliding_reduce(
    x: Tensor,
    window: int,
    op: Callable[[Tensor, Tensor], Tensor],
    init,
    axis: int = -1,
) -> Tensor:
    """Generic sliding reduction over any associative ``op`` (min/max/...).

    The two-phase structure generalized to non-invertible monoids via the
    block decomposition (van Herk / Gil-Werman): prefix and suffix scans
    within blocks of size ``window``, then one ``op`` per output. Work is
    O(n) ops independent of the window size. For ``torch.maximum`` /
    ``torch.minimum`` the block scans are ``torch.cummax`` / ``cummin``;
    any other ``op`` takes a log-depth scan.
    """
    n = x.shape[axis]
    if window < 1 or window > n:
        raise ValueError(f"bad window {window} for length {n}")
    if window == 1:
        return x
    x = torch.movedim(x, axis, -1)
    out_len = n - window + 1
    pad = (-n) % window
    xp = torch.cat([x, torch.full(x.shape[:-1] + (pad,), init, dtype=x.dtype,
                                  device=x.device)], dim=-1)
    nblk = xp.shape[-1] // window
    blocks = xp.reshape(xp.shape[:-1] + (nblk, window))
    if op is torch.maximum or op is torch.minimum:
        cum = torch.cummax if op is torch.maximum else torch.cummin
        pre = cum(blocks, dim=-1).values
        suf = cum(blocks.flip(-1), dim=-1).values.flip(-1)
    else:
        pre = _log_scan(blocks, op)
        suf = _log_scan(blocks, op, reverse=True)
    pre = pre.reshape(xp.shape)
    suf = suf.reshape(xp.shape)
    # y[i] = op(suffix_scan_at(i), prefix_scan_at(i + w - 1))
    y = op(suf[..., :out_len], pre[..., window - 1 : window - 1 + out_len])
    return torch.movedim(y, -1, axis)


def _extreme(dtype: torch.dtype, *, lo: bool):
    """Identity element for max (lo) / min reductions — ±inf for floats,
    the integer bounds for int dtypes (int8 codes from a requant-chained
    conv max-pool exactly: the per-tensor grid is monotonic)."""
    if dtype.is_floating_point:
        return float("-inf") if lo else float("inf")
    info = torch.iinfo(dtype)
    return info.min if lo else info.max


def sliding_max(x: Tensor, window: int, axis: int = -1) -> Tensor:
    return sliding_reduce(x, window, torch.maximum,
                          _extreme(x.dtype, lo=True), axis=axis)


def sliding_max_shift(x: Tensor, window: int, axis: int = -1) -> Tensor:
    """Sliding max via shift-and-max — the O(n·w) baseline the two-phase
    block decomposition (``sliding_max``) is benchmarked against."""
    n = x.shape[axis]
    _check_window(window, n)
    out_len = n - window + 1
    acc = x.narrow(axis, 0, out_len)
    for k in range(1, window):
        acc = torch.maximum(acc, x.narrow(axis, k, out_len))
    return acc


def sliding_min(x: Tensor, window: int, axis: int = -1) -> Tensor:
    return sliding_reduce(x, window, torch.minimum,
                          _extreme(x.dtype, lo=False), axis=axis)


def sliding_avg(x: Tensor, window: int, axis: int = -1) -> Tensor:
    """The scan's sum, already cast to x's type, divided by ``window``."""
    return (sliding_sum_scan(x, window, axis=axis) / window).to(x.dtype)


# ---------------------------------------------------------------------------
# Pooling (NHWC), built on the sliding sums
# ---------------------------------------------------------------------------

def _pool2d(x: Tensor, window, stride, reducer, axis_pair) -> Tensor:
    wh, ww = window
    sh, sw = stride
    y = reducer(x, wh, axis=axis_pair[0])
    y = reducer(y, ww, axis=axis_pair[1])
    return y[:, ::sh, ::sw, :]


def max_pool2d(x: Tensor, window=(2, 2), stride=None) -> Tensor:
    """Max pooling, NHWC. Sliding-reduce evaluation (O(n) comparisons)."""
    stride = stride or window
    return _pool2d(x, window, stride, sliding_max, (1, 2))


def avg_pool2d(x: Tensor, window=(2, 2), stride=None) -> Tensor:
    """Average pooling, NHWC, two-phase scan evaluation."""
    stride = stride or window
    return _pool2d(x, window, stride, sliding_avg, (1, 2))


def pool_ref(x: Tensor, *, window: int, op: str = "sum") -> Tensor:
    """VALID sliding pooling along axis 1 oracle. x: (B, L, C)."""
    if op == "sum":
        return sliding_sum_scan(x, window, axis=1)
    if op == "avg":
        return (sliding_sum_scan(x, window, axis=1).float() / window).to(x.dtype)
    if op == "max":
        return sliding_max(x, window, axis=1)
    raise ValueError(op)
