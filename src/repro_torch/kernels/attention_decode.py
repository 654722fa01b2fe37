"""Single-query decode attention over a floating-point or int8 KV cache.

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

The int8 cache holds codes with float32 scales ``k_scale`` and ``v_scale``,
(B, S, KV, 1), one per (position, head) row. As in the reference, the K
scale folds into the scores after the dot, ``s * (k_scale * sm_scale)``,
and the V scale into the probabilities before ``p . v``; the denominator
sums the unscaled probabilities. No float copy of the cache is made except
in the oracle, which dequantizes first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gemm_plan import PlanError

DEFAULT_BLOCK_S = 128
MAX_G = 8
MAX_D = 256
_KV_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# q, k, v, k_scale, v_scale, lengths, out, workspace, tickets; B, S, KV, G,
# D, rows, nsplit; sm_scale; q_bf16, kv_kind; stream
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# the kernel's split choice: as many blocks as the card's SMs hold at once
# (two of 256 threads each), and no split shorter than 64 rows (a tile of
# the kernel's)
BLOCKS_PER_SM = 2
MIN_SPLIT_ROWS = 64
# a split's scores stay in the block's shared memory
MAX_SPLIT_ROWS = 512


def decode_splits(bkv: int, n: int, sms: int = build.DEFAULT_SMS,
                  rows: int | None = None) -> tuple[int, int]:
    """(splits, rows a split) for ``bkv`` (slot, head) pairs over ``n``
    cache rows on a card of ``sms`` SMs: about ``BLOCKS_PER_SM * sms``
    blocks in all, from
    ``MIN_SPLIT_ROWS`` (all n in one split below that) to
    ``MAX_SPLIT_ROWS`` rows a split. The splits [i * rows, min(n, (i + 1)
    * rows)) cover the n rows and each holds at least one. The wrapper
    passes n = S, the rows a slot may hold: the lengths live on the card,
    and a slot's splits past its length do nothing. ``rows`` forces the
    split length (1 to min(n, ``MAX_SPLIT_ROWS``); ``PlanError`` else)."""
    if rows is not None:
        if int(rows) != rows or not 1 <= rows <= min(n, MAX_SPLIT_ROWS):
            raise PlanError(f"split rows={rows}: 1 to "
                            f"{min(n, MAX_SPLIT_ROWS)}")
        return -(-n // int(rows)), int(rows)
    want = max(1, BLOCKS_PER_SM * sms // max(1, bkv))
    rows = max(MIN_SPLIT_ROWS, -(-n // want))
    rows = max(1, min(n, rows, MAX_SPLIT_ROWS))
    return -(-n // rows), rows


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


def _check(q, k, v, lengths, k_scale=None, v_scale=None):
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
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale travel as a pair")
    if (k.dtype == torch.int8) != (k_scale is not None):
        raise ValueError("an int8 cache, and only an int8 cache, takes "
                         "k_scale and v_scale")
    if k_scale is not None:
        want = (*k.shape[:3], 1)
        if k_scale.shape != want or v_scale.shape != want:
            raise ValueError(f"scales {tuple(k_scale.shape)}, "
                             f"{tuple(v_scale.shape)} are not {want}")


def attention_decode_plain(q, k, v, lengths, k_scale=None, v_scale=None, *,
                           block_s: int = DEFAULT_BLOCK_S):
    """Blocked online softmax over kv_seq blocks of ``block_s`` rows, with
    the score pass as a multiply-reduce over D and the scale folds of the
    int8 cache (the reference's ``attention_decode_jax``: ``_block_pass``,
    ``_block_pv``)."""
    _check(q, k, v, lengths, k_scale, v_scale)
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
        s = (qf[:, None] * kc[:, :, :, None, :]).sum(-1)  # (B, s, KV, G)
        if k_scale is None:
            s = s * sm
        else:  # the row's K scale, (B, s, KV, 1), folds in after the dot
            s = s * (k_scale[:, s0 : s0 + bs] * sm)
        s = torch.where(valid[:, :, None, None], s,
                        torch.full_like(s, float("-inf")))
        m, p, corr, l = _softmax_step(s, m, l, dim=1)
        pw = p if v_scale is None else p * v_scale[:, s0 : s0 + bs]
        pv = torch.einsum("bskg,bskd->bkgd", pw, vc)
        acc = acc * corr.unsqueeze(-1) + pv
    return _finish(l, acc)


def attention_decode_ref(q, k, v, lengths, k_scale=None, v_scale=None):
    """Dequant-view oracle: float K/V (codes times scales for the int8
    cache), one full softmax."""
    _check(q, k, v, lengths, k_scale, v_scale)
    B, KV, G, D = q.shape
    S = k.shape[1]
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf, vf = kf * k_scale, vf * v_scale
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), kf) * D ** -0.5
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, float("-inf")))
    m0 = torch.full((B, KV, G), float("-inf"), device=q.device)
    l0 = torch.zeros((B, KV, G), device=q.device)
    _m, p, _corr, l = _softmax_step(s, m0, l0, dim=-1)
    return _finish(l, torch.einsum("bkgs,bskd->bkgd", p, vf))


@functools.lru_cache(maxsize=64)
def _workspace_floats(B, KV, G, D, nsplit) -> int:
    """Float32 workspace the kernel's splits write for the merge."""
    fn = build.library("attention_decode").decode_attention_workspace
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn(B, KV, G, D, nsplit)


# the kernel's per-(slot, head) merge counters, by (device, stream): zeroed
# once, and left zeroed by every launch
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def _launch(q, k, v, lengths, k_scale=None, v_scale=None,
            plan=None) -> torch.Tensor:
    B, KV, G, D = q.shape
    S = k.shape[1]
    if G > MAX_G or D > MAX_D:
        raise ValueError(f"kernel takes G <= {MAX_G} and D <= {MAX_D}, got "
                         f"G={G}, D={D}")
    if (q.dtype not in (torch.float32, torch.bfloat16)
            or k.dtype not in _KV_KINDS or v.dtype != k.dtype):
        raise TypeError(f"kernel takes float32/bfloat16 q and one of float32, "
                        f"bfloat16, int8 for k and v, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    scales = () if k_scale is None else (k_scale, v_scale)
    if any(t.device != q.device for t in (k, v, lengths, *scales)):
        raise ValueError("q, k, v, lengths and scales must lie on one device")
    fn = build.entry("attention_decode", "decode_attention", _ARGTYPES)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    ks = vs = None
    if scales:
        ks, vs = (t.float().contiguous() for t in scales)
    if lengths.dtype != torch.int32:
        lengths = lengths.to(torch.int32)
    lengths = lengths.contiguous()
    nsplit, rows = decode_splits(B * KV, S, build.sm_count(q.device),
                                 rows=(plan or {}).get("split_rows"))
    # one allocation: the output, then the splits' softmax state that the
    # last block of each (slot, head) merges
    n_out = B * KV * G * D
    buf = torch.empty(n_out + _workspace_floats(B, KV, G, D, nsplit),
                      dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = _tickets(q.device, stream, B * KV)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), lengths.data_ptr(),
        buf.data_ptr(), buf.data_ptr() + 4 * n_out if nsplit > 1 else None,
        tickets.data_ptr(), B, S, KV, G, D, rows, nsplit, D ** -0.5,
        int(q.dtype == torch.bfloat16), _KV_KINDS[k.dtype], stream,
    )
    build.check("attention_decode", code)
    if ks is None:
        decode_attention.launches += 1
    else:
        decode_attention.launches_int8 += 1
    decode_attention.last_plan = (nsplit, rows)
    return buf[:n_out].view(B, KV, G, D)


def decode_attention(q, k, v, lengths, k_scale=None, v_scale=None, *,
                     plan: dict | None = None):
    """Fused decode attention: the CUDA kernel for CUDA tensors, the plain
    blocked version (one block spanning the cache, as the reference's CPU
    path runs it) for CPU tensors. An int8 cache comes with its float32
    scales (B, S, KV, 1). Lengths above S count as S. ``plan``'s
    ``split_rows`` forces the kernel's split length (``decode_splits``);
    the plain version takes no plan.
    ``decode_attention.launches`` counts kernel launches over a float
    cache, ``decode_attention.launches_int8`` over an int8 cache;
    ``decode_attention.last_plan`` is the last launch's (splits, rows)."""
    _check(q, k, v, lengths, k_scale, v_scale)
    if q.device.type == "cuda":
        return _launch(q, k, v, lengths, k_scale, v_scale, plan=plan)
    if q.device.type == "cpu":
        return attention_decode_plain(q, k, v, lengths, k_scale, v_scale,
                                      block_s=k.shape[1])
    raise ValueError(f"no decode_attention for device {q.device}")


decode_attention.launches = 0
decode_attention.launches_int8 = 0
decode_attention.last_plan = None
