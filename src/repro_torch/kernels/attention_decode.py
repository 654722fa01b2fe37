"""Single-query decode attention over a floating-point KV cache.

``decode_attention`` is the wrapper: on CUDA tensors it launches the Hopper
kernel ``csrc/attention_decode.cu``; on CPU tensors it runs
``attention_decode_plain``, the blocked online softmax of the reference's
``attention_decode_jax``. ``attention_decode_ref`` is the dequant-view
oracle (one full softmax). All three share ``_softmax_step`` and
``_finish`` with the reference's guards, so they agree on edge inputs: a
block with no valid row leaves the carry untouched, and a slot with no
valid row (length 0) gives a zero row.

Shapes: q (B, KV, G, D) grouped queries; k, v (B, S, KV, D) cache leaves;
lengths (B,) int32 valid prefix per slot. Returns (B, KV, G, D) float32.
The int8 cache variant of the reference is not ported yet.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

DEFAULT_BLOCK_S = 128
MAX_G = 8
MAX_D = 128
# q, k, v, lengths, out, workspace; B, S, KV, G, D; sm_scale; q_bf16,
# kv_bf16; stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _softmax_step(s, m_prev, l_prev, *, dim):
    """THE online-softmax update: new running max, masked probabilities,
    carry correction and new denominator, reducing scores over ``dim``.
    All -inf scores leave a carry that holds data untouched (corr 1, p 0)
    and add nothing to one that does not (m_prev -inf gives corr 0)."""
    m_new = torch.maximum(m_prev, s.amax(dim=dim))
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.exp(s - m_safe.unsqueeze(dim))
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    corr = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - m_safe),
                       torch.zeros_like(m_prev))
    return m_new, p, corr, l_prev * corr + p.sum(dim=dim)


def _finish(l, acc):
    """acc / l, where l == 0 (no valid row) gives 0."""
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    return acc / l_safe.unsqueeze(-1)


def _check(q, k, v, lengths):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not form (B, KV, G, D) and "
                         "(B, S, KV, D)")
    B, KV, G, D = q.shape
    if k.shape[0] != B or k.shape[2] != KV or k.shape[3] != D:
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)} is not ({B},)")


def attention_decode_plain(q, k, v, lengths, *, block_s: int = DEFAULT_BLOCK_S):
    """Blocked online softmax over kv_seq blocks of ``block_s`` rows, with
    the score pass as a multiply-reduce over D (the reference's
    ``attention_decode_jax``, fp cache)."""
    _check(q, k, v, lengths)
    B, KV, G, D = q.shape
    S = k.shape[1]
    qf = q.float()
    sm = D ** -0.5
    m = torch.full((B, KV, G), float("-inf"), device=q.device)
    l = torch.zeros((B, KV, G), device=q.device)
    acc = torch.zeros((B, KV, G, D), device=q.device)
    bs = min(block_s, S)
    for s0 in range(0, S, bs):
        kc = k[:, s0 : s0 + bs].float()  # (B, s, KV, D)
        vc = v[:, s0 : s0 + bs].float()
        pos = torch.arange(s0, s0 + kc.shape[1], device=q.device)
        valid = pos[None, :] < lengths[:, None].to(pos.dtype)  # (B, s)
        s = (qf[:, None] * kc[:, :, :, None, :]).sum(-1) * sm  # (B, s, KV, G)
        s = torch.where(valid[:, :, None, None], s,
                        torch.full_like(s, float("-inf")))
        m, p, corr, l = _softmax_step(s, m, l, dim=1)
        pv = torch.einsum("bskg,bskd->bkgd", p, vc)
        acc = acc * corr.unsqueeze(-1) + pv
    return _finish(l, acc)


def attention_decode_ref(q, k, v, lengths):
    """Dequant-view oracle (fp cache): float K/V, one full softmax."""
    _check(q, k, v, lengths)
    B, KV, G, D = q.shape
    S = k.shape[1]
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), kf) * D ** -0.5
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, float("-inf")))
    m0 = torch.full((B, KV, G), float("-inf"), device=q.device)
    l0 = torch.zeros((B, KV, G), device=q.device)
    _m, p, _corr, l = _softmax_step(s, m0, l0, dim=-1)
    return _finish(l, torch.einsum("bkgs,bskd->bkgd", p, vf))


@functools.lru_cache(maxsize=64)
def _workspace_floats(B, S, KV, G, D) -> int:
    """Float32 workspace the kernel's split pass writes for its merge pass."""
    fn = build.library("attention_decode").decode_attention_workspace
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn(B, S, KV, G, D)


def _launch(q, k, v, lengths) -> torch.Tensor:
    B, KV, G, D = q.shape
    S = k.shape[1]
    if G > MAX_G or D > MAX_D:
        raise ValueError(f"kernel takes G <= {MAX_G} and D <= {MAX_D}, got "
                         f"G={G}, D={D}")
    fl = (torch.float32, torch.bfloat16)
    if q.dtype not in fl or k.dtype not in fl or v.dtype != k.dtype:
        raise TypeError(f"kernel takes float32/bfloat16 q and one such type "
                        f"for k and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == v.device == lengths.device == q.device):
        raise ValueError("q, k, v and lengths must lie on one device")
    fn = build.entry("attention_decode", "decode_attention", _ARGTYPES)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if lengths.dtype != torch.int32:
        lengths = lengths.to(torch.int32)
    lengths = lengths.contiguous()
    # one allocation: the output, then the per-split softmax state that the
    # kernel's second pass merges
    n_out = B * KV * G * D
    buf = torch.empty(n_out + _workspace_floats(B, S, KV, G, D),
                      dtype=torch.float32, device=q.device)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        buf.data_ptr(), buf.data_ptr() + 4 * n_out, B, S, KV, G, D, D ** -0.5,
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check("attention_decode", code)
    decode_attention.launches += 1
    return buf[:n_out].view(B, KV, G, D)


def decode_attention(q, k, v, lengths):
    """Fused decode attention: the CUDA kernel for CUDA tensors, the plain
    blocked version (one block spanning the cache, as the reference's CPU
    path runs it) for CPU tensors. Lengths above S count as S.
    ``decode_attention.launches`` counts kernel launches."""
    _check(q, k, v, lengths)
    if q.device.type == "cuda":
        return _launch(q, k, v, lengths)
    if q.device.type == "cpu":
        return attention_decode_plain(q, k, v, lengths, block_s=k.shape[1])
    raise ValueError(f"no decode_attention for device {q.device}")


decode_attention.launches = 0
