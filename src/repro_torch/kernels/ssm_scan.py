"""The selective-SSM scan, forward only (``repro.kernels.ssm_scan``):

    h_t = abar_t ⊙ h_{t-1} + bx_t          (B, D, N) state, float32
    y_t = Σ_n h_t[..., n] · c_t[n]         (B, D) output

``ssm_scan`` launches the Hopper kernel (``csrc/ssm_scan.cu``) on a CUDA
tensor and runs ``ssm_scan_plain`` (the reference's ``ssm_scan_ref``: a
sequential float32 loop over L) on a CPU tensor. Any other device raises;
nothing falls back from the kernel to the plain version.
``ssm_scan.launches`` counts kernel launches.

Contract (the TPU kernel's ``ssm_scan_pallas``): abar, bx (B, L, D, N) and
c (B, L, N) float32 or bfloat16 of one type, h0 (B, D, N), taken as
float32; returns y (B, L, D) in abar's type and h_last (B, D, N) float32,
the state after position L - 1. Both take any N, as the reference does
(jamba's d_state is 16): the kernel is compiled for N in 1–16, 24, 32, 48
and 64, runs another N up to 64 at the next of those widths with the extra
state lanes masked, and walks L once for each group of 64 lanes above 64,
adding the groups' float32 partial y in order before the one cast. The
reference's ``tile_d`` and ``chunk_l`` tile its grid and have no
counterpart: the kernel walks all of L in one thread per (b, d).

No model path calls it: the port's mamba prefill runs the associative
scan, as the reference's does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# the widest group of state lanes the kernel walks at once
GROUP_N = 64
# abar, bx, c, h0, y, h_last, yacc; B, L, D, N, is_bf16; stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(abar, bx, c, h0) -> None:
    if abar.dim() != 4 or bx.shape != abar.shape:
        raise ValueError(f"abar {tuple(abar.shape)} and bx {tuple(bx.shape)} "
                         "are not two (B, L, D, N)")
    B, L, D, N = abar.shape
    if c.shape != (B, L, N) or h0.shape != (B, D, N):
        raise ValueError(f"c {tuple(c.shape)} / h0 {tuple(h0.shape)} are not "
                         f"({B}, {L}, {N}) / ({B}, {D}, {N})")
    if L < 1:
        raise ValueError("the scan needs L >= 1")


def ssm_scan_plain(abar, bx, c, h0):
    """The scan in plain torch, position by position in float32 (the
    reference's ``ssm_scan_ref``)."""
    _check(abar, bx, c, h0)
    a, b, cf = abar.float(), bx.float(), c.float()
    h = h0.float()
    ys = []
    for t in range(abar.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append((h * cf[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1).to(abar.dtype), h


def _launch(abar, bx, c, h0):
    dt = abar.dtype
    if dt not in (torch.float32, torch.bfloat16) or bx.dtype != dt or \
            c.dtype != dt:
        raise TypeError("kernel takes float32 or bfloat16 abar, bx and c of "
                        f"one type, got {abar.dtype}, {bx.dtype}, {c.dtype}")
    if any(t.device != abar.device for t in (bx, c, h0)):
        raise ValueError("abar, bx, c and h0 must lie on one device")
    B, L, D, N = abar.shape
    fn = build.entry("ssm_scan", "ssm_scan", _ARGTYPES)
    abar, bx, c = abar.contiguous(), bx.contiguous(), c.contiguous()
    h0 = h0.float().contiguous()
    y = torch.empty((B, L, D), dtype=dt, device=abar.device)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=abar.device)
    # the groups' partial y, summed in float32 before the one cast
    yacc = (torch.empty((B, L, D), dtype=torch.float32, device=abar.device)
            if N > GROUP_N else None)
    code = fn(abar.data_ptr(), bx.data_ptr(), c.data_ptr(), h0.data_ptr(),
              y.data_ptr(), h_last.data_ptr(),
              None if yacc is None else yacc.data_ptr(), B, L, D, N,
              int(dt == torch.bfloat16),
              torch.cuda.current_stream(abar.device).cuda_stream)
    build.check("ssm_scan", code)
    ssm_scan.launches += 1
    return y, h_last


def ssm_scan(abar: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, h_last) of the selective scan: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    _check(abar, bx, c, h0)
    if abar.device.type == "cuda":
        return _launch(abar, bx, c, h0)
    if abar.device.type == "cpu":
        return ssm_scan_plain(abar, bx, c, h0)
    raise ValueError(f"no ssm_scan for device {abar.device}")


ssm_scan.launches = 0
