"""Sliding-window conv1d, dense and depthwise, with a fused bias +
activation epilogue.

``conv1d_sliding`` is the wrapper of the dense conv: on a CUDA tensor it
launches the Hopper kernel ``csrc/sliding_conv1d.cu``, the conv as one
product on ``csrc/gemm_mma.cuh``'s main loop (output positions by (tap,
channel) pairs, each position's K·Cin column one run of x), with the
tile, the split of the taps and the copy widths from ``gemm_plan`` and
the card's SM count (``conv1d_launch``); on a CPU tensor it runs
``conv1d_sliding_plain``, the same arithmetic in plain torch. Any other
device raises. Nothing falls back from the kernel to the plain
version. ``conv1d_depthwise`` is the same for the depthwise conv (kernel
``csrc/conv1d_depthwise.cu`` on ``csrc/depthwise_rows.cuh``'s staged
body, planned by ``gemm_plan.depthwise_plan`` from the card's SM count,
``depthwise_launch``; plain version ``conv1d_depthwise_plain``).

Contract (the TPU kernel's, ``repro.kernels.sliding_conv1d``): VALID conv1d
on an input the caller already padded. x (B, L, Cin), w (K, Cin, Cout) of
x's type, float32 or bfloat16; bias (Cout,) or None; output
(B, (L - K) // stride + 1, Cout) in x's type. The sum runs in float32; bias
and activation are applied to the float32 sum, then one cast. With
``save_preact=True`` both return ``(y, z)``: z is the post-bias
pre-activation in x's type, written by the same epilogue (the residual the
backward pass forms ``dz = dy · act'(z)`` from).

Depthwise contract (``conv1d_depthwise_pallas``): VALID depthwise conv1d on
an already padded input. x (B, L, C) float32 or bfloat16, w (K, C) of x's
type, bias (C,) or None; output (B, (L - K) // stride + 1, C) in x's type.
Products and sums in float32, tap by tap; bias and activation on the
float32 sum, then one cast. With ``save_preact=True`` it returns
``(y, z)``, z the post-bias pre-activation in x's type, as the dense conv
does.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, gemm_plan

ACTIVATIONS = {None: 0, "none": 0, "relu": 1, "gelu": 2, "silu": 3}
# x, w, bias, y, z, ws; B, L, Cin, Cout, K, stride, Lout, act, is_bf16,
# tile, splits, per, va, vb; stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
# x, w, bias, y, z; B, L, C, K, stride, Lout, act, is_bf16, rows, stages,
# blocks, copy_bytes; stream
_DW_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def apply_activation(x: torch.Tensor, activation: str | None) -> torch.Tensor:
    """Epilogue activation on the float32 sum. gelu is the tanh
    approximation (``jax.nn.gelu(approximate=True)``)."""
    if activation in (None, "none"):
        return x
    if activation == "relu":
        return torch.relu(x)
    if activation == "gelu":
        return F.gelu(x, approximate="tanh")
    if activation == "silu":
        return F.silu(x)
    raise ValueError(f"unknown activation {activation!r}")


def _check(x, w, bias, stride, activation) -> int:
    if x.dim() != 3 or w.dim() != 3 or w.shape[1] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "form (B, L, Cin) and (K, Cin, Cout)")
    if bias is not None and bias.shape != (w.shape[2],):
        raise ValueError(f"bias {tuple(bias.shape)} is not (Cout,)")
    if stride < 1:
        raise ValueError(f"stride {stride} < 1")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    out_len = (x.shape[1] - w.shape[0]) // stride + 1
    if out_len < 1:
        raise ValueError(f"filter K={w.shape[0]} (stride {stride}) exceeds "
                         f"input length {x.shape[1]}")
    return out_len


def conv1d_sliding_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
    stride: int = 1, activation: str = "none", save_preact: bool = False,
):
    """The kernel's function in plain torch: one shifted float32 matrix
    product per tap, then bias, activation and the cast to x's type."""
    out_len = _check(x, w, bias, stride, activation)
    xf, wf = x.float(), w.float()
    span = (out_len - 1) * stride + 1
    acc = torch.zeros((x.shape[0], out_len, w.shape[2]), dtype=torch.float32,
                      device=x.device)
    for k in range(w.shape[0]):
        acc = acc + xf[:, k : k + span : stride] @ wf[k]
    if bias is not None:
        acc = acc + bias.float()
    y = apply_activation(acc, activation).to(x.dtype)
    return (y, acc.to(x.dtype)) if save_preact else y


def conv1d_launch(x, w, stride, lout):
    """The launch geometry of the conv's product on ``csrc/gemm_mma.cuh``
    (row 1), for contiguous x and w: the plan (tile and split of the K·Cin
    taps), the copy widths of x (along each position's whole column) and
    of w, and the splits' float32 workspace (None for one split)."""
    B, L, Cin = x.shape
    K = w.shape[0]
    return gemm_plan.launch(x, w, B * lout, K * Cin,
                            gemm_plan.conv2d_copy_strides(1, L, Cin, K,
                                                          (1, stride)))


def _launch(x, w, bias, stride, activation, out_len, save_preact=False):
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 x and w of the "
                        f"same type, got {x.dtype} and {w.dtype}")
    if w.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("x, w and bias must lie on one device")
    fn = build.entry("sliding_conv1d", "sliding_conv1d", _ARGTYPES)
    x, w = x.contiguous(), w.contiguous()
    b32 = None if bias is None else bias.float().contiguous()
    B, L, Cin = x.shape
    K, _, Cout = w.shape
    plan, va, vb, ws = conv1d_launch(x, w, stride, out_len)
    y = torch.empty((B, out_len, Cout), dtype=x.dtype, device=x.device)
    z = torch.empty_like(y) if save_preact else None
    code = fn(
        x.data_ptr(), w.data_ptr(), None if b32 is None else b32.data_ptr(),
        y.data_ptr(), None if z is None else z.data_ptr(),
        None if ws is None else ws.data_ptr(),
        B, L, Cin, Cout, K, stride, out_len,
        ACTIVATIONS[activation], int(x.dtype == torch.bfloat16),
        plan.tile.id, plan.splits, plan.per, va, vb,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("sliding_conv1d", code)
    conv1d_sliding.launches += 1
    return (y, z) if save_preact else y


def conv1d_sliding(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
    stride: int = 1, activation: str = "none", save_preact: bool = False,
):
    """VALID sliding conv1d + bias + activation: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor. ``conv1d_sliding.launches``
    counts kernel launches."""
    out_len = _check(x, w, bias, stride, activation)
    if x.device.type == "cuda":
        return _launch(x, w, bias, stride, activation, out_len, save_preact)
    if x.device.type == "cpu":
        return conv1d_sliding_plain(x, w, bias, stride=stride,
                                    activation=activation,
                                    save_preact=save_preact)
    raise ValueError(f"no sliding_conv1d for device {x.device}")


conv1d_sliding.launches = 0


# ---------------------------------------------------------------------------
# depthwise
# ---------------------------------------------------------------------------

def _check_depthwise(x, w, bias, stride, activation) -> int:
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "form (B, L, C) and (K, C)")
    if bias is not None and bias.shape != (w.shape[1],):
        raise ValueError(f"bias {tuple(bias.shape)} is not (C,)")
    if stride < 1:
        raise ValueError(f"stride {stride} < 1")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    out_len = (x.shape[1] - w.shape[0]) // stride + 1
    if out_len < 1:
        raise ValueError(f"filter K={w.shape[0]} (stride {stride}) exceeds "
                         f"input length {x.shape[1]}")
    return out_len


def conv1d_depthwise_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
    stride: int = 1, activation: str = "none", save_preact: bool = False,
):
    """The depthwise kernel's function in plain torch: one shifted float32
    multiply-add per tap, in tap order, then bias, activation and the cast
    to x's type (and the post-bias sum's, z, with ``save_preact``)."""
    out_len = _check_depthwise(x, w, bias, stride, activation)
    xf, wf = x.float(), w.float()
    span = (out_len - 1) * stride + 1
    acc = None
    for k in range(w.shape[0]):
        t = xf[:, k : k + span : stride] * wf[k]
        acc = t if acc is None else acc + t
    if bias is not None:
        acc = acc + bias.float()
    y = apply_activation(acc, activation).to(x.dtype)
    return (y, acc.to(x.dtype)) if save_preact else y


def depthwise_launch(x, K, stride, out_len):
    """The launch of ``csrc/depthwise_rows.cuh`` over contiguous x (B, L,
    C), shared by the float and int8 depthwise wrappers: the plan on x's
    card (``gemm_plan.depthwise_plan``) and the width of x's staged pieces
    (each row starts C elements after the last)."""
    B, _, C = x.shape
    el = x.element_size()
    plan = gemm_plan.depthwise_plan(B, out_len, C, el, K, stride,
                                    build.sm_count(x.device))
    return plan, gemm_plan.copy_bytes(el, [x.data_ptr()], [C])


def _launch_depthwise(x, w, bias, stride, activation, out_len,
                      save_preact=False):
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 x and w of the "
                        f"same type, got {x.dtype} and {w.dtype}")
    if w.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("x, w and bias must lie on one device")
    fn = build.entry("conv1d_depthwise", "conv1d_depthwise", _DW_ARGTYPES)
    x, w = x.contiguous(), w.contiguous()
    b32 = None if bias is None else bias.float().contiguous()
    B, L, C = x.shape
    plan, cb = depthwise_launch(x, w.shape[0], stride, out_len)
    y = torch.empty((B, out_len, C), dtype=x.dtype, device=x.device)
    z = torch.empty_like(y) if save_preact else None
    code = fn(
        x.data_ptr(), w.data_ptr(), None if b32 is None else b32.data_ptr(),
        y.data_ptr(), None if z is None else z.data_ptr(),
        B, L, C, w.shape[0], stride, out_len,
        ACTIVATIONS[activation], int(x.dtype == torch.bfloat16),
        plan.rows, plan.stages, plan.blocks, cb,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("conv1d_depthwise", code)
    conv1d_depthwise.launches += 1
    return (y, z) if save_preact else y


def conv1d_depthwise(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
    stride: int = 1, activation: str = "none", save_preact: bool = False,
):
    """VALID depthwise sliding conv1d + bias + activation: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor.
    ``conv1d_depthwise.launches`` counts kernel launches."""
    out_len = _check_depthwise(x, w, bias, stride, activation)
    if x.device.type == "cuda":
        return _launch_depthwise(x, w, bias, stride, activation, out_len,
                                 save_preact)
    if x.device.type == "cpu":
        return conv1d_depthwise_plain(x, w, bias, stride=stride,
                                      activation=activation,
                                      save_preact=save_preact)
    raise ValueError(f"no conv1d_depthwise for device {x.device}")


conv1d_depthwise.launches = 0
