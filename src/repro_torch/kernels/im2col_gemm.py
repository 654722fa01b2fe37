"""The paper's GEMM-convolution baselines: a tiled GEMM and the im2col
convolutions (``repro.kernels.im2col_gemm``).

  * ``matmul``: C = A @ B, (M, K) @ (K, N), float32 sums, output in A's
    type (the TPU kernel ``matmul_pallas``). Its tile, split-K and copy
    widths come from ``gemm_plan`` and the card's SM count.
  * ``conv1d_im2col_fused`` / ``conv2d_im2col_fused``: VALID conv1d (x (B,
    L, Cin) NLC, w (K, Cin, Cout)) and conv2d (x (B, H, W, Cin) NHWC, w
    (kh, kw, Cin, Cout) HWIO), any stride, output in x's type: each tile's
    im2col column is built on chip and contracted by one GEMM (the TPU
    kernels ``conv{1d,2d}_im2col_fused_pallas``). The 2-D one runs on
    row 5's loop, its column built tap by tap; its plan and copy widths
    come from ``gemm_plan`` (``im2col_copy_strides``).
  * ``conv1d_im2col_hbm`` / ``conv2d_im2col_hbm``: the whole (B·out,
    K·Cin) column tensor built in device memory by torch ops, in x's type,
    then one ``matmul``: the memory-bloat baseline. Not kernels of their
    own, as in the reference.

Each kernel wrapper launches its Hopper kernel (``csrc/im2col_gemm.cu``)
on a CUDA tensor and runs its plain version (``matmul_plain``,
``conv1d_im2col_fused_plain``, ``conv2d_im2col_fused_plain``: a float32
column by unfold, one float32 product, one cast back) on a CPU tensor. Any
other device raises; nothing falls back from the kernel to the plain
version. ``.launches`` on each wrapper counts its kernel's launches.

The kernels take float32 or bfloat16 operands of one type and sum in
float32. Where the reference's bfloat16 GEMM rounds its running sum to
bfloat16 after every 128-deep slice of K (its output block is the
accumulator), these round once. There is no epilogue: callers apply bias
and activation unfused (``ops.epilogue_unfused``), as the reference's
``ops`` does. The baselines are forward only, as in the reference, which
gives them no VJP: a CUDA call whose inputs need a gradient raises (the
kernel's output has no ``grad_fn``). The reference's tile arguments
(``tm``, ``tn``, ``tk``, ``tile_l``, ``tile_h``, ``tile_w``) are checked and
do not change the result: the kernels tile for the card on their own.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, gemm_plan

DEFAULT_TM = DEFAULT_TN = DEFAULT_TK = 128
DEFAULT_TILE_L = 256
DEFAULT_TILE_H, DEFAULT_TILE_W = 16, 64
# a, b, c, ws; M, N, K, is_bf16, tile, splits, per, va, vb; stream
_MM_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# x, w, y; B, L, Cin, Cout, K, stride, Lout, is_bf16; stream
_1D_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# x, w, y, ws; B, H, W, Cin, Cout, kh, kw, sh, sw, oh, ow, is_bf16, tile,
# splits, per, va, vb; stream
_2D_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17 + [ctypes.c_void_p]


def _check_tiles(**tiles) -> None:
    for name, v in tiles.items():
        if v < 1:
            raise ValueError(f"{name} {v} < 1")


def _forward_only(name: str, *ts) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{name} is forward only (the reference gives it no VJP): call "
            "it under torch.no_grad() or on inputs that need no gradient, "
            "or differentiate through the sliding or xla backend")


def _kernel_operands(*ts) -> None:
    dt = ts[0].dtype
    if dt not in (torch.float32, torch.bfloat16) or any(
            t.dtype != dt for t in ts):
        raise TypeError("kernel takes float32 or bfloat16 operands of one "
                        f"type, got {[t.dtype for t in ts]}")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("operands must lie on one device")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_mm(a, b) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         "form (M, K) and (K, N)")
    if 0 in a.shape or b.shape[1] == 0:
        raise ValueError(f"empty product {tuple(a.shape)} @ {tuple(b.shape)}")


def _check_conv1d(x, w, stride) -> int:
    """Raise on what the kernel does not take; return Lout."""
    if x.dim() != 3 or w.dim() != 3 or w.shape[1] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "form (B, L, Cin) and (K, Cin, Cout)")
    if stride < 1:
        raise ValueError(f"stride {stride} < 1")
    lout = (x.shape[1] - w.shape[0]) // stride + 1
    if lout < 1 or 0 in x.shape or 0 in w.shape:
        raise ValueError(f"filter {w.shape[0]} (stride {stride}) exceeds "
                         f"input length {x.shape[1]}")
    return lout


def _check_conv2d(x, w, stride) -> tuple[int, int]:
    """Raise on what the kernel does not take; return (oh, ow)."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "form (B, H, W, Cin) and (kh, kw, Cin, Cout)")
    sh, sw = stride
    if sh < 1 or sw < 1:
        raise ValueError(f"stride {tuple(stride)} has an entry < 1")
    kh, kw = w.shape[:2]
    H, W = x.shape[1:3]
    oh, ow = (H - kh) // sh + 1, (W - kw) // sw + 1
    if oh < 1 or ow < 1 or 0 in x.shape or 0 in w.shape:
        raise ValueError(f"filter ({kh},{kw}) (stride {tuple(stride)}) "
                         f"exceeds input ({H},{W})")
    return oh, ow


def columns_1d(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """The (B·Lout, K·Cin) im2col matrix of a VALID conv1d, contiguous, in
    x's type: row (b, l) holds x[b, l·stride + t, c] at column t·Cin + c."""
    B, _, Cin = x.shape
    win = x.unfold(1, k, stride)  # (B, Lout, Cin, K)
    # at stride 1 the reshape can be an overlapping view of x: copy
    return win.transpose(2, 3).reshape(B * win.shape[1], k * Cin).contiguous()


def columns_2d(x: torch.Tensor, kh: int, kw: int,
               stride: tuple[int, int]) -> torch.Tensor:
    """The (B·oh·ow, kh·kw·Cin) im2col matrix of a VALID conv2d,
    contiguous, in x's type: row (b, oy, ox) holds x[b, oy·sh + i,
    ox·sw + j, c] at column (i·kw + j)·Cin + c."""
    B, _, _, Cin = x.shape
    win = x.unfold(1, kh, stride[0]).unfold(2, kw, stride[1])
    # (B, oh, ow, Cin, kh, kw) -> (B, oh, ow, kh, kw, Cin)
    oh, ow = win.shape[1:3]
    return win.permute(0, 1, 2, 4, 5, 3).reshape(
        B * oh * ow, kh * kw * Cin).contiguous()


# ---------------------------------------------------------------------------
# Row 5: the tiled GEMM
# ---------------------------------------------------------------------------

def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: a float32 product, one cast
    to a's type."""
    _check_mm(a, b)
    return (a.float() @ b.float()).to(a.dtype)


def _launch_matmul(a, b):
    _kernel_operands(a, b)
    fn = build.entry("im2col_gemm", "im2col_matmul", _MM_ARGTYPES)
    a, b = a.contiguous(), b.contiguous()
    M, K = a.shape
    N = b.shape[1]
    plan = gemm_plan.gemm_plan(M, N, K, a.dtype, build.sm_count(a.device))
    el = a.element_size()
    va = gemm_plan.copy_bytes(el, [a.data_ptr()], [K])
    vb = gemm_plan.copy_bytes(el, [b.data_ptr()], [N])
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    ws = (torch.empty((plan.splits * M * N,), dtype=torch.float32,
                      device=a.device) if plan.splits > 1 else None)
    code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
              None if ws is None else ws.data_ptr(), M, N, K,
              int(a.dtype == torch.bfloat16), plan.tile.id, plan.splits,
              plan.per, va, vb, _stream(a))
    build.check("im2col_gemm", code)
    matmul.launches += 1
    return c


def matmul(a: torch.Tensor, b: torch.Tensor, *, tm: int = DEFAULT_TM,
           tn: int = DEFAULT_TN, tk: int = DEFAULT_TK) -> torch.Tensor:
    """C = A @ B: the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor. ``matmul.launches`` counts kernel launches."""
    _check_mm(a, b)
    _check_tiles(tm=tm, tn=tn, tk=tk)
    if a.device.type == "cuda":
        _forward_only("matmul", a, b)
        return _launch_matmul(a, b)
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    raise ValueError(f"no matmul for device {a.device}")


matmul.launches = 0


# ---------------------------------------------------------------------------
# Rows 6 and 7: the column tile built on chip, then one GEMM
# ---------------------------------------------------------------------------

def conv1d_im2col_fused_plain(x: torch.Tensor, w: torch.Tensor, *,
                              stride: int = 1) -> torch.Tensor:
    """The kernel's function in plain torch: the float32 column, one
    float32 product with the (K·Cin, Cout) weights, one cast to x's
    type."""
    lout = _check_conv1d(x, w, stride)
    K, Cin, Cout = w.shape
    y = columns_1d(x.float(), K, stride) @ w.float().reshape(K * Cin, Cout)
    return y.reshape(x.shape[0], lout, Cout).to(x.dtype)


def _launch_conv1d(x, w, stride, lout):
    _kernel_operands(x, w)
    fn = build.entry("im2col_gemm", "im2col_conv1d", _1D_ARGTYPES)
    x, w = x.contiguous(), w.contiguous()
    B, L, Cin = x.shape
    K, _, Cout = w.shape
    y = torch.empty((B, lout, Cout), dtype=x.dtype, device=x.device)
    code = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, L, Cin, Cout, K,
              stride, lout, int(x.dtype == torch.bfloat16), _stream(x))
    build.check("im2col_gemm", code)
    conv1d_im2col_fused.launches += 1
    return y


def conv1d_im2col_fused(x: torch.Tensor, w: torch.Tensor, *,
                        stride: int = 1,
                        tile_l: int = DEFAULT_TILE_L) -> torch.Tensor:
    """VALID conv1d through per-tile im2col on chip + one GEMM: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor.
    ``conv1d_im2col_fused.launches`` counts kernel launches."""
    lout = _check_conv1d(x, w, stride)
    _check_tiles(tile_l=tile_l)
    if x.device.type == "cuda":
        _forward_only("conv1d_im2col_fused", x, w)
        return _launch_conv1d(x, w, stride, lout)
    if x.device.type == "cpu":
        return conv1d_im2col_fused_plain(x, w, stride=stride)
    raise ValueError(f"no conv1d_im2col_fused for device {x.device}")


conv1d_im2col_fused.launches = 0


def conv2d_im2col_fused_plain(x: torch.Tensor, w: torch.Tensor, *,
                              stride: tuple[int, int] = (1, 1)
                              ) -> torch.Tensor:
    """The kernel's function in plain torch: the float32 column, one
    float32 product with the (kh·kw·Cin, Cout) weights, one cast to x's
    type."""
    stride = tuple(stride)
    oh, ow = _check_conv2d(x, w, stride)
    kh, kw, Cin, Cout = w.shape
    y = columns_2d(x.float(), kh, kw, stride) @ w.float().reshape(
        kh * kw * Cin, Cout)
    return y.reshape(x.shape[0], oh, ow, Cout).to(x.dtype)


def conv2d_launch(x, w, stride, oh, ow):
    """Row 7's launch geometry on ``csrc/gemm_mma.cuh`` for contiguous x
    and w: the plan (tile and split of the kh·kw·Cin taps), the copy
    widths of x (tap by tap) and w, and the splits' float32 workspace
    (None for one split)."""
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    M = B * oh * ow
    plan = gemm_plan.gemm_plan(M, Cout, kh * kw * Cin, x.dtype,
                               build.sm_count(x.device))
    va = gemm_plan.copy_bytes(x.element_size(), [x.data_ptr()],
                              gemm_plan.im2col_copy_strides(H, W, Cin, stride))
    vb = gemm_plan.copy_bytes(w.element_size(), [w.data_ptr()], [Cout])
    ws = (torch.empty((plan.splits * M * Cout,), dtype=torch.float32,
                      device=x.device) if plan.splits > 1 else None)
    return plan, va, vb, ws


def _launch_conv2d(x, w, stride, oh, ow):
    _kernel_operands(x, w)
    fn = build.entry("im2col_gemm", "im2col_conv2d", _2D_ARGTYPES)
    x, w = x.contiguous(), w.contiguous()
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    plan, va, vb, ws = conv2d_launch(x, w, stride, oh, ow)
    y = torch.empty((B, oh, ow, Cout), dtype=x.dtype, device=x.device)
    code = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
              None if ws is None else ws.data_ptr(), B, H, W, Cin, Cout,
              kh, kw, stride[0], stride[1], oh, ow,
              int(x.dtype == torch.bfloat16), plan.tile.id, plan.splits,
              plan.per, va, vb, _stream(x))
    build.check("im2col_gemm", code)
    conv2d_im2col_fused.launches += 1
    return y


def conv2d_im2col_fused(x: torch.Tensor, w: torch.Tensor, *,
                        stride: tuple[int, int] = (1, 1),
                        tile_h: int = DEFAULT_TILE_H,
                        tile_w: int = DEFAULT_TILE_W) -> torch.Tensor:
    """VALID conv2d through per-tile im2col on chip + one GEMM (the fused
    baseline; ``conv2d_im2col_hbm`` is the memory-bloat one): the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor.
    ``conv2d_im2col_fused.launches`` counts kernel launches."""
    stride = tuple(stride)
    oh, ow = _check_conv2d(x, w, stride)
    _check_tiles(tile_h=tile_h, tile_w=tile_w)
    if x.device.type == "cuda":
        _forward_only("conv2d_im2col_fused", x, w)
        return _launch_conv2d(x, w, stride, oh, ow)
    if x.device.type == "cpu":
        return conv2d_im2col_fused_plain(x, w, stride=stride)
    raise ValueError(f"no conv2d_im2col_fused for device {x.device}")


conv2d_im2col_fused.launches = 0


# ---------------------------------------------------------------------------
# The column tensor in device memory, then row 5
# ---------------------------------------------------------------------------

def conv1d_im2col_hbm(x: torch.Tensor, w: torch.Tensor, *,
                      stride: int = 1) -> torch.Tensor:
    """VALID conv1d: the (B·Lout, K·Cin) column tensor in device memory,
    then one ``matmul`` (one launch of the GEMM kernel on a CUDA
    tensor)."""
    lout = _check_conv1d(x, w, stride)
    if x.device.type == "cuda":
        _forward_only("conv1d_im2col_hbm", x, w)
    K, Cin, Cout = w.shape
    y = matmul(columns_1d(x, K, stride), w.reshape(K * Cin, Cout))
    return y.reshape(x.shape[0], lout, Cout)


def conv2d_im2col_hbm(x: torch.Tensor, w: torch.Tensor, *,
                      stride: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """VALID conv2d: the (B·oh·ow, kh·kw·Cin) column tensor in device
    memory, then one ``matmul`` (the paper's memory-bloat baseline)."""
    stride = tuple(stride)
    oh, ow = _check_conv2d(x, w, stride)
    if x.device.type == "cuda":
        _forward_only("conv2d_im2col_hbm", x, w)
    kh, kw, Cin, Cout = w.shape
    y = matmul(columns_2d(x, kh, kw, stride), w.reshape(kh * kw * Cin, Cout))
    return y.reshape(x.shape[0], oh, ow, Cout)
