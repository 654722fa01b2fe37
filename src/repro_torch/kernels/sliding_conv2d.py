"""Sliding-window conv2d with a fused bias + activation epilogue.

``conv2d_sliding`` is the wrapper: on a CUDA tensor it launches the Hopper
kernel ``csrc/sliding_conv2d.cu``, the conv as one product on
``csrc/gemm_mma.cuh``'s main loop (output positions by filter taps, x
gathered a filter row's run at a time), with the tile, the split of the
taps and the copy widths from ``gemm_plan`` and the card's SM count; on a
CPU tensor it runs ``conv2d_sliding_plain``, the same arithmetic in plain
torch. Any other device raises. Nothing falls back from the kernel to the
plain version.

Contract (the TPU kernel's, ``repro.kernels.sliding_conv2d``): VALID conv2d
on an input the caller already padded. x (B, H, W, Cin) NHWC, w (kh, kw,
Cin, Cout) HWIO of x's type, float32 or bfloat16; stride (sh, sw); bias
(Cout,) or None; output (B, (H - kh) // sh + 1, (W - kw) // sw + 1, Cout)
in x's type. The sum runs in float32; bias and activation are applied to
the float32 sum, then one cast. With ``save_preact=True`` it returns
``(y, z)``: z is the post-bias pre-activation in x's type, written by the
same epilogue (the residual the backward pass forms ``dz = dy · act'(z)``
from).

The reference's tiling arguments (``tile_h``, ``tile_w``, ``cin_block``,
``cout_block``, ``regime``) are accepted and checked by its rule; they
choose how the TPU groups taps in VMEM and do not change the result, so
the kernel tiles for the card on its own.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.conv import regime_for
from repro_torch.kernels import build, gemm_plan
from repro_torch.kernels.sliding_conv1d import ACTIVATIONS, apply_activation

DEFAULT_TILE_H = 16
DEFAULT_TILE_W = 128
REGIMES = ("custom", "generic", "compound")
# x, w, bias, y, z, ws; B, H, W, Cin, Cout, kh, kw, sh, sw, oh, ow, act,
# is_bf16, tile, splits, per, va, vb; stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 18 + [ctypes.c_void_p]


def resolve_regime(kh: int, kw: int, regime: str | None) -> str:
    """The reference's regime rule: custom for square 3x3 and 5x5, else by
    the filter width (``core.conv.regime_for``)."""
    if regime is None:
        return "custom" if (kh == kw and kh in (3, 5)) else regime_for(kw)
    if regime not in REGIMES:
        raise ValueError(f"unknown regime {regime!r}; one of {REGIMES}")
    return regime


def check_tiles(tile_h, tile_w, cin_block, cout_block) -> None:
    """The reference's rule for its tiling arguments."""
    for name, v in (("tile_h", tile_h), ("tile_w", tile_w)):
        if v < 1:
            raise ValueError(f"{name} {v} < 1")
    for name, v in (("cin_block", cin_block), ("cout_block", cout_block)):
        if v is not None and v < 0:
            raise ValueError(f"{name} {v} < 0")


def _check(x, w, bias, stride, activation, tile_h, tile_w, cin_block,
           cout_block, regime) -> tuple[int, int]:
    """Raise on what the kernel does not take; return (oh, ow)."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "form (B, H, W, Cin) and (kh, kw, Cin, Cout)")
    if bias is not None and bias.shape != (w.shape[3],):
        raise ValueError(f"bias {tuple(bias.shape)} is not (Cout,)")
    sh, sw = stride
    if sh < 1 or sw < 1:
        raise ValueError(f"stride {tuple(stride)} has an entry < 1")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    check_tiles(tile_h, tile_w, cin_block, cout_block)
    kh, kw = w.shape[:2]
    resolve_regime(kh, kw, regime)
    H, W = x.shape[1:3]
    oh, ow = (H - kh) // sh + 1, (W - kw) // sw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"filter ({kh},{kw}) (stride {tuple(stride)}) "
                         f"exceeds input ({H},{W})")
    return oh, ow


def conv2d_sliding_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
    stride: tuple[int, int] = (1, 1), activation: str = "none",
    save_preact: bool = False,
):
    """The kernel's function in plain torch: one filter row at a time, the
    (tap, channel) pairs of the row contracted together in one float32
    matrix product over the pixels' strided input rows, then bias,
    activation and the cast to x's type."""
    oh, ow = _check(x, w, bias, stride, activation, DEFAULT_TILE_H,
                    DEFAULT_TILE_W, None, None, None)
    sh, sw = stride
    kh, kw, cin, cout = w.shape
    xf, wf = x.float(), w.float()
    B = x.shape[0]
    acc = torch.zeros((B, oh, ow, cout), dtype=torch.float32, device=x.device)
    for i in range(kh):
        rows = xf[:, i : i + (oh - 1) * sh + 1 : sh]  # (B, oh, W, Cin)
        # (B, oh, ow, kw, Cin): pixel ox's taps of filter row i
        taps = rows.unfold(2, kw, sw)[:, :, :ow].permute(0, 1, 2, 4, 3)
        acc = acc + taps.reshape(B, oh, ow, kw * cin) @ wf[i].reshape(
            kw * cin, cout)
    if bias is not None:
        acc = acc + bias.float()
    y = apply_activation(acc, activation).to(x.dtype)
    return (y, acc.to(x.dtype)) if save_preact else y


def product_launch(x, w, stride, oh, ow, plan=None):
    """The launch geometry of the conv's product on ``csrc/gemm_mma.cuh``
    (rows 4 and 14), for contiguous x and w: the plan (tile and split of
    the kh·kw·Cin taps; ``plan``'s ``tile`` and ``splits`` force them),
    the copy widths of x and w, and the splits' workspace (None for one
    split; int32 partials for int8 x)."""
    B, H, W, Cin = x.shape
    kh, kw = w.shape[:2]
    return gemm_plan.launch(x, w, B * oh * ow, kh * kw * Cin,
                            gemm_plan.conv2d_copy_strides(H, W, Cin, kw,
                                                          stride),
                            **gemm_plan.forced(plan))


def _launch(x, w, bias, stride, activation, oh, ow, save_preact=False,
            plan=None):
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 x and w of the "
                        f"same type, got {x.dtype} and {w.dtype}")
    if w.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("x, w and bias must lie on one device")
    fn = build.entry("sliding_conv2d", "sliding_conv2d", _ARGTYPES)
    x, w = x.contiguous(), w.contiguous()
    b32 = None if bias is None else bias.float().contiguous()
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    plan, va, vb, ws = product_launch(x, w, stride, oh, ow, plan)
    y = torch.empty((B, oh, ow, Cout), dtype=x.dtype, device=x.device)
    z = torch.empty_like(y) if save_preact else None
    code = fn(
        x.data_ptr(), w.data_ptr(), None if b32 is None else b32.data_ptr(),
        y.data_ptr(), None if z is None else z.data_ptr(),
        None if ws is None else ws.data_ptr(),
        B, H, W, Cin, Cout, kh, kw, stride[0], stride[1], oh, ow,
        ACTIVATIONS[activation], int(x.dtype == torch.bfloat16),
        plan.tile.id, plan.splits, plan.per, va, vb,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("sliding_conv2d", code)
    conv2d_sliding.launches += 1
    conv2d_sliding.last_plan = plan
    return (y, z) if save_preact else y


def conv2d_sliding(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
    stride: tuple[int, int] = (1, 1), activation: str = "none",
    tile_h: int = DEFAULT_TILE_H, tile_w: int = DEFAULT_TILE_W,
    cin_block: int | None = None, cout_block: int | None = None,
    regime: str | None = None, save_preact: bool = False,
    plan: dict | None = None,
):
    """VALID sliding conv2d + bias + activation: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor. ``plan``'s ``tile`` and
    ``splits`` force the kernel's launch plan; the plain version takes
    none. ``conv2d_sliding.launches`` counts kernel launches,
    ``conv2d_sliding.last_plan`` is the last launch's ``GemmPlan``."""
    stride = tuple(stride)
    oh, ow = _check(x, w, bias, stride, activation, tile_h, tile_w, cin_block,
                    cout_block, regime)
    if x.device.type == "cuda":
        return _launch(x, w, bias, stride, activation, oh, ow, save_preact,
                       plan=plan)
    if x.device.type == "cpu":
        return conv2d_sliding_plain(x, w, bias, stride=stride,
                                    activation=activation,
                                    save_preact=save_preact)
    raise ValueError(f"no sliding_conv2d for device {x.device}")


conv2d_sliding.launches = 0
conv2d_sliding.last_plan = None
