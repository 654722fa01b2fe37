"""Backward pass of the sliding conv1d and conv2d
(``repro.kernels.sliding_conv_bwd``).

  * ``act_bwd``: ``dz = dy · act'(z)`` from the saved post-bias
    pre-activation ``z``, the exact derivative of the epilogue's float32
    activation.
  * dx: a stride-1 sliding correlation of the dilated, padded gradient with
    the flipped, Cin↔Cout-transposed weights (``conv1d_dx_operands``). It
    runs through the forward conv kernel, so it needs no kernel of its own.
  * dw/db: ``conv1d_bwd_dw`` is the wrapper. On a CUDA tensor it launches
    the Hopper kernel ``csrc/sliding_conv_bwd.cu``, dw as one product over
    the output positions on ``csrc/gemm_mma.cuh``'s main loop, with the
    tile, the split of the positions and the copy widths from
    ``gemm_plan`` and the card's SM count (``dw_launch``); on a CPU tensor
    it runs ``conv1d_bwd_dw_plain``, the same sums in plain torch. Any
    other device raises. Nothing falls back from the kernel to the plain
    version.
  * depthwise: dx (``conv1d_depthwise_dx``) runs the forward depthwise
    kernel on the dilated, padded gradient with the taps flipped; dw/db
    through ``conv1d_depthwise_bwd_dw``, the wrapper of
    ``csrc/conv1d_depthwise_bwd.cu`` (plain version
    ``conv1d_depthwise_bwd_dw_plain``), on the same terms, its split of the
    row tiles from ``gemm_plan.depthwise_dw_splits`` and the card's SM
    count.
  * conv2d: dx (``conv2d_dx``) runs the forward 2-D conv kernel on the
    dilated, padded gradient with the flipped, Cin↔Cout-transposed
    weights (``conv2d_dx_operands``); dw/db through ``conv2d_bwd_dw``, the
    wrapper of ``csrc/sliding_conv2d_bwd.cu`` (plain version
    ``conv2d_bwd_dw_plain``), on the same terms.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import (build, gemm_plan, sliding_conv1d,
                                  sliding_conv2d)

# x, dz, dw, db, ws; B, L, Cin, Cout, K, stride, Lout, is_bf16, tile,
# splits, per, va, vb; stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
# x, dz, dw, db, ws; B, L, C, K, stride, Lout, is_bf16, splits, sms; stream
_DW_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# x, dz, dw, db, ws; B, H, W, Cin, Cout, kh, kw, sh, sw, oh, ow, is_bf16,
# tile, splits, per, va, vb; stream
_2D_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 17 + [ctypes.c_void_p]

_GELU_C = math.sqrt(2.0 / math.pi)


def act_bwd(dy: torch.Tensor, z: torch.Tensor | None,
            activation: str) -> torch.Tensor:
    """dz = dy · act'(z) in float32, cast to dy's type. relu' is 0 at 0;
    gelu is the tanh approximation, as in the forward epilogue."""
    if activation in (None, "none"):
        return dy
    if z is None:
        raise ValueError(f"activation {activation!r} needs the saved preact")
    zf, g = z.float(), dy.float()
    if activation == "relu":
        d = (zf > 0).float()
    elif activation == "gelu":
        t = torch.tanh(_GELU_C * (zf + 0.044715 * zf ** 3))
        d = 0.5 * (1 + t) + 0.5 * zf * (1 - t * t) * _GELU_C * (
            1 + 3 * 0.044715 * zf * zf)
    elif activation == "silu":
        s = torch.sigmoid(zf)
        d = s * (1 + zf * (1 - s))
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return (g * d).to(dy.dtype)


def dilate1d(dy: torch.Tensor, stride: int) -> torch.Tensor:
    """Insert ``stride - 1`` zero rows between dy's rows along axis 1."""
    if stride == 1:
        return dy
    B, n, C = dy.shape
    out = dy.new_zeros((B, (n - 1) * stride + 1, C))
    out[:, ::stride] = dy
    return out


def conv1d_dx_operands(dz: torch.Tensor, w: torch.Tensor, *, stride: int):
    """(dilated and padded dz, flipped Cin↔Cout-transposed weights) for dx."""
    K = w.shape[0]
    dzp = F.pad(dilate1d(dz, stride), (0, 0, K - 1, K - 1))
    wt = torch.flip(w, (0,)).transpose(1, 2).contiguous()  # (K, Cout, Cin)
    return dzp, wt


def dilate2d(dy: torch.Tensor, stride: tuple[int, int]) -> torch.Tensor:
    """Insert zeros between dy's rows and columns (axes 1 and 2)."""
    sh, sw = stride
    if sh == 1 and sw == 1:
        return dy
    B, h, w, C = dy.shape
    out = dy.new_zeros((B, (h - 1) * sh + 1, (w - 1) * sw + 1, C))
    out[:, ::sh, ::sw] = dy
    return out


def conv2d_dx_operands(dz: torch.Tensor, w: torch.Tensor, *,
                       stride: tuple[int, int]):
    """(dilated and padded dz, flipped Cin↔Cout-transposed weights) for dx."""
    kh, kw = w.shape[:2]
    dzp = F.pad(dilate2d(dz, stride), (0, 0, kw - 1, kw - 1, kh - 1, kh - 1))
    wt = torch.flip(w, (0, 1)).transpose(2, 3).contiguous()  # (kh, kw, Cout, Cin)
    return dzp, wt


def _fit_len(dx: torch.Tensor, L: int, axis: int = 1) -> torch.Tensor:
    """Zero-pad dx along ``axis`` up to the forward input's length there:
    trailing rows (or columns) that the forward pass never read get zero
    gradient."""
    short = L - dx.shape[axis]
    if short > 0:
        pads = [0, 0] * (dx.dim() - axis)
        pads[-1] = short
        dx = F.pad(dx, pads)
    return dx


def conv1d_dx(dz: torch.Tensor, w: torch.Tensor, *, stride: int,
              L: int) -> torch.Tensor:
    """dx through the forward sliding conv (its kernel on a CUDA tensor) on
    the dilated gradient: stride 1, no bias, no activation."""
    dzp, wt = conv1d_dx_operands(dz, w, stride=stride)
    return _fit_len(sliding_conv1d.conv1d_sliding(dzp, wt, None, stride=1), L)


def _check(x, dz, K, stride) -> None:
    if x.dim() != 3 or dz.dim() != 3 or x.shape[0] != dz.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and dz {tuple(dz.shape)} do not "
                         "form (B, L, Cin) and (B, Lout, Cout)")
    if K < 1 or stride < 1:
        raise ValueError(f"K={K} and stride={stride} must be >= 1")
    if (dz.shape[1] - 1) * stride + K > x.shape[1]:
        raise ValueError(f"dz of {dz.shape[1]} rows at K={K}, stride {stride} "
                         f"reads past x's {x.shape[1]} rows")


def conv1d_bwd_dw_plain(x: torch.Tensor, dz: torch.Tensor, K: int, *,
                        stride: int = 1, has_bias: bool = False):
    """The kernel's function in plain torch: one float32 matrix product per
    tap over all (batch, row) pairs. Returns (dw (K, Cin, Cout) float32,
    db (Cout,) float32 or None)."""
    _check(x, dz, K, stride)
    Lout, Cout = dz.shape[1], dz.shape[2]
    span = (Lout - 1) * stride + 1
    xf, g = x.float(), dz.float().reshape(-1, Cout)
    dw = torch.stack([
        xf[:, k : k + span : stride].reshape(-1, x.shape[2]).T @ g
        for k in range(K)
    ])
    return dw, (g.sum(dim=0) if has_bias else None)


def _check_kernel_operands(x, dz) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16) or dz.dtype != x.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 x and dz of the "
                        f"same type, got {x.dtype} and {dz.dtype}")
    if dz.device != x.device:
        raise ValueError("x and dz must lie on one device")


def dw_launch(x, dz, filter_len, W, Cin, kw, sw, has_bias):
    """The launch geometry of a weight gradient's product on
    ``csrc/gemm_mma.cuh`` (rows 10 and 12), for contiguous x and dz: dw
    (``filter_len`` = kh·kw·Cin rows, Cout) over the output positions of
    dz, the plan, the copy widths of x (along a filter row's run, W the
    input row's width) and of dz, and the splits' float32 workspace (with
    room for db's partials where ``has_bias``; None for one split)."""
    Cout = dz.shape[-1]
    return gemm_plan.launch(x, dz, filter_len, dz.numel() // Cout,
                            gemm_plan.dw_copy_strides(W, Cin, kw, sw),
                            col_sums=has_bias)


def _dw_outputs(x, dw_shape, Cout, has_bias):
    dw = torch.empty(dw_shape, dtype=torch.float32, device=x.device)
    db = (torch.empty((Cout,), dtype=torch.float32, device=x.device)
          if has_bias else None)
    return dw, db


def _launch(x, dz, K, stride, has_bias):
    _check_kernel_operands(x, dz)
    fn = build.entry("sliding_conv_bwd", "conv1d_bwd_dw", _ARGTYPES)
    x, dz = x.contiguous(), dz.contiguous()
    B, L, Cin = x.shape
    Lout, Cout = dz.shape[1], dz.shape[2]
    # dw (K*Cin, Cout) = the product over the B*Lout positions
    plan, va, vb, ws = dw_launch(x, dz, K * Cin, L, Cin, K, stride, has_bias)
    dw, db = _dw_outputs(x, (K, Cin, Cout), Cout, has_bias)
    code = fn(
        x.data_ptr(), dz.data_ptr(), dw.data_ptr(),
        None if db is None else db.data_ptr(),
        None if ws is None else ws.data_ptr(),
        B, L, Cin, Cout, K, stride, Lout, int(x.dtype == torch.bfloat16),
        plan.tile.id, plan.splits, plan.per, va, vb,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("sliding_conv_bwd", code)
    conv1d_bwd_dw.launches += 1
    return dw, db


def conv1d_bwd_dw(x: torch.Tensor, dz: torch.Tensor, K: int, *,
                  stride: int = 1, has_bias: bool = False):
    """Weight and bias gradient of the VALID sliding conv1d: x (B, L, Cin)
    the padded forward input, dz (B, Lout, Cout) the gradient after the
    activation. Returns (dw (K, Cin, Cout) float32, db (Cout,) float32 or
    None): the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor. ``conv1d_bwd_dw.launches`` counts kernel launches."""
    _check(x, dz, K, stride)
    if x.device.type == "cuda":
        return _launch(x, dz, K, stride, has_bias)
    if x.device.type == "cpu":
        return conv1d_bwd_dw_plain(x, dz, K, stride=stride, has_bias=has_bias)
    raise ValueError(f"no conv1d_bwd_dw for device {x.device}")


conv1d_bwd_dw.launches = 0


# ---------------------------------------------------------------------------
# depthwise
# ---------------------------------------------------------------------------

def conv1d_depthwise_dx(dz: torch.Tensor, w: torch.Tensor, *, stride: int,
                        L: int) -> torch.Tensor:
    """dx of the VALID depthwise conv through the forward depthwise conv
    (its kernel on a CUDA tensor): dz dilated by the stride and padded
    K-1 rows on each side, the taps flipped, stride 1, no bias, no
    activation; then zero rows up to the input length ``L``."""
    K = w.shape[0]
    dzp = F.pad(dilate1d(dz, stride), (0, 0, K - 1, K - 1))
    dx = sliding_conv1d.conv1d_depthwise(dzp, torch.flip(w, (0,)), None,
                                         stride=1)
    return _fit_len(dx, L)


def _check_depthwise(x, dz, K, stride) -> None:
    if (x.dim() != 3 or dz.dim() != 3 or x.shape[0] != dz.shape[0]
            or x.shape[2] != dz.shape[2]):
        raise ValueError(f"x {tuple(x.shape)} and dz {tuple(dz.shape)} do not "
                         "form (B, L, C) and (B, Lout, C)")
    _check(x, dz, K, stride)


def conv1d_depthwise_bwd_dw_plain(x: torch.Tensor, dz: torch.Tensor, K: int,
                                  *, stride: int = 1, has_bias: bool = False):
    """The depthwise kernel's function in plain torch: one float32 multiply
    and sum per tap over all (batch, row) pairs. Returns (dw (K, C)
    float32, db (C,) float32 or None)."""
    _check_depthwise(x, dz, K, stride)
    span = (dz.shape[1] - 1) * stride + 1
    xf, g = x.float(), dz.float()
    dw = torch.stack([(xf[:, k : k + span : stride] * g).sum(dim=(0, 1))
                      for k in range(K)])
    return dw, (g.sum(dim=(0, 1)) if has_bias else None)


def _launch_depthwise(x, dz, K, stride, has_bias):
    _check_kernel_operands(x, dz)
    fn = build.entry("conv1d_depthwise_bwd", "conv1d_depthwise_bwd_dw",
                     _DW_ARGTYPES)
    x, dz = x.contiguous(), dz.contiguous()
    B, L, C = x.shape
    Lout = dz.shape[1]
    dw = torch.empty((K, C), dtype=torch.float32, device=x.device)
    db = (torch.empty((C,), dtype=torch.float32, device=x.device)
          if has_bias else None)
    sms = build.sm_count(x.device)
    S = gemm_plan.depthwise_dw_splits(B, C, K, Lout, x.dtype, sms)
    ws = (torch.empty((S * (K * C + C),), dtype=torch.float32,
                      device=x.device) if S > 1 else None)
    code = fn(
        x.data_ptr(), dz.data_ptr(), dw.data_ptr(),
        None if db is None else db.data_ptr(),
        None if ws is None else ws.data_ptr(),
        B, L, C, K, stride, Lout, int(x.dtype == torch.bfloat16), S, sms,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("conv1d_depthwise_bwd", code)
    conv1d_depthwise_bwd_dw.launches += 1
    return dw, db


def conv1d_depthwise_bwd_dw(x: torch.Tensor, dz: torch.Tensor, K: int, *,
                            stride: int = 1, has_bias: bool = False):
    """Weight and bias gradient of the VALID depthwise conv1d: x (B, L, C)
    the padded forward input, dz (B, Lout, C) the gradient after the
    activation. Returns (dw (K, C) float32, db (C,) float32 or None): the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor.
    ``conv1d_depthwise_bwd_dw.launches`` counts kernel launches."""
    _check_depthwise(x, dz, K, stride)
    if x.device.type == "cuda":
        return _launch_depthwise(x, dz, K, stride, has_bias)
    if x.device.type == "cpu":
        return conv1d_depthwise_bwd_dw_plain(x, dz, K, stride=stride,
                                             has_bias=has_bias)
    raise ValueError(f"no conv1d_depthwise_bwd_dw for device {x.device}")


conv1d_depthwise_bwd_dw.launches = 0


# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------

def conv2d_dx(dz: torch.Tensor, w: torch.Tensor, *, stride: tuple[int, int],
              H: int, W: int) -> torch.Tensor:
    """dx through the forward sliding conv2d (its kernel on a CUDA tensor)
    on the dilated gradient: stride 1, no bias, no activation; then zero
    rows and columns up to the input's (H, W)."""
    dzp, wt = conv2d_dx_operands(dz, w, stride=stride)
    dx = sliding_conv2d.conv2d_sliding(dzp, wt, None, stride=(1, 1))
    return _fit_len(_fit_len(dx, H, 1), W, 2)


def _check_2d(x, dz, kh, kw, stride, tile_h, tile_w, cin_block,
              cout_block) -> None:
    if x.dim() != 4 or dz.dim() != 4 or x.shape[0] != dz.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and dz {tuple(dz.shape)} do not "
                         "form (B, H, W, Cin) and (B, oh, ow, Cout)")
    sh, sw = stride
    if kh < 1 or kw < 1 or sh < 1 or sw < 1:
        raise ValueError(f"filter ({kh},{kw}) and stride {tuple(stride)} "
                         "must be >= 1")
    oh, ow = dz.shape[1:3]
    if (oh - 1) * sh + kh > x.shape[1] or (ow - 1) * sw + kw > x.shape[2]:
        raise ValueError(f"dz of ({oh},{ow}) at filter ({kh},{kw}), stride "
                         f"{tuple(stride)} reads past x's "
                         f"{tuple(x.shape[1:3])}")
    sliding_conv2d.check_tiles(tile_h, tile_w, cin_block, cout_block)


def conv2d_bwd_dw_plain(x: torch.Tensor, dz: torch.Tensor,
                        w_shape_hw: tuple[int, int], *,
                        stride: tuple[int, int] = (1, 1),
                        has_bias: bool = False):
    """The kernel's function in plain torch: one float32 matrix product per
    filter row over all output positions, the row's (tap, channel) pairs
    together. Returns (dw (kh, kw, Cin, Cout) float32, db (Cout,) float32
    or None)."""
    kh, kw = w_shape_hw
    _check_2d(x, dz, kh, kw, stride, sliding_conv2d.DEFAULT_TILE_H,
              sliding_conv2d.DEFAULT_TILE_W, None, None)
    sh, sw = stride
    B, oh, ow, cout = dz.shape
    cin = x.shape[3]
    xf, g = x.float(), dz.float().reshape(-1, cout)
    rows = []
    for i in range(kh):
        xr = xf[:, i : i + (oh - 1) * sh + 1 : sh]  # (B, oh, W, Cin)
        # (B, oh, ow, kw, Cin): position (oy, ox)'s taps of filter row i
        taps = xr.unfold(2, kw, sw)[:, :, :ow].permute(0, 1, 2, 4, 3)
        rows.append((taps.reshape(-1, kw * cin).T @ g).reshape(kw, cin, cout))
    return torch.stack(rows), (g.sum(dim=0) if has_bias else None)


def _launch_2d(x, dz, kh, kw, stride, has_bias):
    _check_kernel_operands(x, dz)
    fn = build.entry("sliding_conv2d_bwd", "conv2d_bwd_dw", _2D_ARGTYPES)
    x, dz = x.contiguous(), dz.contiguous()
    B, H, W, Cin = x.shape
    oh, ow, Cout = dz.shape[1:]
    # dw (kh*kw*Cin, Cout) = the product over the B*oh*ow positions
    plan, va, vb, ws = dw_launch(x, dz, kh * kw * Cin, W, Cin, kw, stride[1],
                                 has_bias)
    dw, db = _dw_outputs(x, (kh, kw, Cin, Cout), Cout, has_bias)
    code = fn(
        x.data_ptr(), dz.data_ptr(), dw.data_ptr(),
        None if db is None else db.data_ptr(),
        None if ws is None else ws.data_ptr(),
        B, H, W, Cin, Cout, kh, kw, stride[0], stride[1], oh, ow,
        int(x.dtype == torch.bfloat16), plan.tile.id, plan.splits, plan.per,
        va, vb, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("sliding_conv2d_bwd", code)
    conv2d_bwd_dw.launches += 1
    return dw, db


def conv2d_bwd_dw(x: torch.Tensor, dz: torch.Tensor,
                  w_shape_hw: tuple[int, int], *,
                  stride: tuple[int, int] = (1, 1),
                  tile_h: int = sliding_conv2d.DEFAULT_TILE_H,
                  tile_w: int = sliding_conv2d.DEFAULT_TILE_W,
                  cin_block: int | None = None, cout_block: int | None = None,
                  has_bias: bool = False):
    """Weight and bias gradient of the VALID sliding conv2d: x (B, H, W,
    Cin) the padded forward input, dz (B, oh, ow, Cout) the gradient after
    the activation. Returns (dw (kh, kw, Cin, Cout) float32, db (Cout,)
    float32 or None): the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor. The reference's tiling arguments are checked and do
    not change the result. ``conv2d_bwd_dw.launches`` counts kernel
    launches."""
    kh, kw = w_shape_hw
    stride = tuple(stride)
    _check_2d(x, dz, kh, kw, stride, tile_h, tile_w, cin_block, cout_block)
    if x.device.type == "cuda":
        return _launch_2d(x, dz, kh, kw, stride, has_bias)
    if x.device.type == "cpu":
        return conv2d_bwd_dw_plain(x, dz, (kh, kw), stride=stride,
                                   has_bias=has_bias)
    raise ValueError(f"no conv2d_bwd_dw for device {x.device}")


conv2d_bwd_dw.launches = 0
