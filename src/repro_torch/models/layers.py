"""Transformer building blocks on tensors (the whisper, jamba and dense /
llava subset of ``repro.models.layers``).

Conventions, as in the reference: activations in ``compute_dtype``;
reductions, softmax and norms in float32; grouped-query attention with
grouped einsums (no KV head repetition in memory); flash-style chunked
attention past ``attn_chunk``; decode against a static KV cache; logits
summed in float32; the training loss chunked over the sequence. Rotary
embeddings (jamba) rotate q and k in float32 where the caller passes
positions; whisper passes none and uses sinusoidal positions.

Tensor parallelism (Megatron): a model on a mesh computes on its rank's
blocks of the leaves (``sharding.Runtime.placement``) with the explicit
collectives its ``Split`` names (``tp_layout``). Attention and the MLP are
column- then row-parallel: their input enters through ``copy_in`` and
their output leaves through ``reduce_out``, and each rank runs its heads
(read from the leaves' shapes) or its block of the hidden width. Where
``kv_heads`` does not split (gemma's one KV head), ``wk`` and ``wv`` split
``head_dim`` instead, and k and v are all-gathered over it before
``k_norm`` and RoPE, which pair the halves of a head: every rank then
holds the whole k and v (and the whole K/V cache) and reads the KV heads
its query heads use. The embedding and the logits are vocab-parallel:
the lookup masks the tokens outside the rank's rows and sums over the
ranks; serving gathers the last position's logits over the vocabulary,
and the loss takes a vocab-parallel logsumexp and the gold logit from the
rank that holds it, so training never builds the whole logits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import conv as core_conv
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (
    ParamDef, Runtime, mesh_axes, torch_dtype,
)
from repro_torch.kernels import ops
from repro_torch.quant import calibrate, qconv

NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def cdtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_plain": lambda x: F.gelu(x, approximate="tanh"),
        "relu_sq": lambda x: torch.square(torch.relu(x)),
    }[name]


# ---------------------------------------------------------------------------
# fused conv -> bias -> activation
# ---------------------------------------------------------------------------

def _quant_mode(w, precision: str) -> str | None:
    if precision in ("w8a8", "w8a16"):
        return precision
    if isinstance(w, qconv.QuantizedWeight):  # int8 leaf: weight-only
        return "w8a16"
    return None


def conv1d_bias_act(
    x: torch.Tensor,
    w,
    b: torch.Tensor | None,
    *,
    activation: str = "none",
    stride: int = 1,
    padding="VALID",
    backend: str = "sliding",
    precision: str = "fp",
    site: str | None = None,
) -> torch.Tensor:
    """Multi-channel conv1d + bias + activation. x: (B, L, Cin), w:
    (K, Cin, Cout) float, cast to x's type as the reference does, or a
    ``QuantizedWeight``. On ``sliding_pallas`` bias and activation run in
    the CUDA kernel's epilogue; the other backends are the ``core.conv``
    twins (``im2col_gemm`` the column-tensor twin, not the fused kernel, as
    in the reference) with the epilogue unfused.

    A calibration site: under ``quant.calibrate.collecting`` the input is
    observed under ``site``. With ``precision`` "w8a8" / "w8a16" (or an int8
    leaf) the conv is quantized: on ``sliding_pallas`` through the int8
    kernel, elsewhere through ``qconv.conv1d_q``'s float32 path. A leaf
    with ``out_scale`` emits int8 on its consumer's grid (w8a8 only); an
    int8 input is the other end of such a chain, on this site's
    ``x_scale``."""
    qleaf = isinstance(w, qconv.QuantizedWeight)
    k, _, cout = (w.q if qleaf else w).shape
    site = site or calibrate.conv_site("conv1d", x.shape[-1], cout, k)
    calibrate.observe(site, x)
    mode = _quant_mode(w, precision)
    if mode is not None:
        qw = w if qleaf else qconv.quantize_weight(w)
        out_scale = qw.out_scale if mode == "w8a8" else None
        if out_scale is None:
            calibrate.note_dequant(site)
        if backend == "sliding_pallas":
            return ops.conv1d(
                x, qw.q, stride=stride, padding=padding, backend=backend,
                bias=b, activation=activation, precision=mode,
                w_scale=qw.scale, x_scale=qw.x_scale, out_scale=out_scale)
        out_dtype = torch.float32 if x.dtype == torch.int8 else x.dtype
        return qconv.conv1d_q(
            x, qw, b, mode=mode, stride=stride, padding=padding,
            x_scale=qw.x_scale, out_scale=out_scale, activation=activation,
            out_dtype=out_dtype, accumulate="fast")
    w = w.to(x.dtype)
    if backend == "sliding_pallas":
        return ops.conv1d(x, w, stride=stride, padding=padding, bias=b,
                          activation=activation)
    cb = "sliding" if backend.startswith("sliding") else backend
    y = core_conv.conv1d(x, w, stride=stride, padding=padding, backend=cb)
    return ops.epilogue_unfused(y, b, activation)


def conv2d_bias_act(
    x: torch.Tensor,
    w,
    b: torch.Tensor | None,
    *,
    activation: str = "none",
    stride: tuple[int, int] = (1, 1),
    padding="VALID",
    backend: str = "sliding",
    precision: str = "fp",
    site: str | None = None,
) -> torch.Tensor:
    """Multi-channel conv2d + bias + activation. x: (B, H, W, Cin), w:
    (kh, kw, Cin, Cout) float, cast to x's type as the reference does, or a
    ``QuantizedWeight``. On ``sliding_pallas`` bias and activation run in
    the 2-D CUDA kernel's epilogue (``ops.conv2d``); the other backends are
    the ``core.conv`` twins with the epilogue unfused. A calibration site,
    observed under ``site`` as in ``conv1d_bias_act``. With ``precision``
    "w8a8" / "w8a16" (or an int8 leaf) the conv is quantized: on
    ``sliding_pallas`` through the int8 conv2d kernel, elsewhere through
    ``qconv.conv2d_q``'s float32 path; a leaf with ``out_scale`` emits int8
    on its consumer's grid (w8a8 only)."""
    qleaf = isinstance(w, qconv.QuantizedWeight)
    wq = w.q if qleaf else w
    site = site or calibrate.conv_site(
        "conv2d", x.shape[-1], wq.shape[-1], f"{wq.shape[0]}x{wq.shape[1]}")
    calibrate.observe(site, x)
    mode = _quant_mode(w, precision)
    if mode is not None:
        qw = w if qleaf else qconv.quantize_weight(w)
        out_scale = qw.out_scale if mode == "w8a8" else None
        if out_scale is None:
            calibrate.note_dequant(site)
        if backend == "sliding_pallas":
            return ops.conv2d(
                x, qw.q, stride=stride, padding=padding, bias=b,
                activation=activation, precision=mode, w_scale=qw.scale,
                x_scale=qw.x_scale, out_scale=out_scale)
        out_dtype = torch.float32 if x.dtype == torch.int8 else x.dtype
        return qconv.conv2d_q(
            x, qw, b, mode=mode, stride=stride, padding=padding,
            x_scale=qw.x_scale, out_scale=out_scale, activation=activation,
            out_dtype=out_dtype, accumulate="fast")
    w = w.to(x.dtype)
    if backend == "sliding_pallas":
        return ops.conv2d(x, w, stride=stride, padding=padding, bias=b,
                          activation=activation)
    cb = "sliding" if backend.startswith("sliding") else backend
    y = core_conv.conv2d(x, w, stride=stride, padding=padding, backend=cb)
    return ops.epilogue_unfused(y, b, activation)


def sinusoidal_positions(length: int, d_model: int, device=None) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=device), dim / d_model)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., L, H, D); positions: (..., L) integer. The two halves of
    the head dim rotate as one complex pair, in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    ang = positions[..., :, None].float() * freqs  # (..., L, D/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Split:
    """A model's tensor-parallel layout on this rank, read once from its
    leaves' placements. Each tuple names the mesh axes of more than one
    rank that split that part, in the placement's order; an empty one
    makes the collectives around it the identity."""

    mesh: Any = None
    heads: tuple = ()  # the query heads of wq and wo (and wk/wv's kv heads)
    kv_gather: tuple = ()  # wk/wv's head_dim: k and v gathered over it
    kv_sel: tuple | None = None  # (first, count) of the whole k/v's heads read
    mlp: tuple = ()  # the MLP's hidden width
    vocab: tuple = ()  # the embedding's and the logits' vocabulary
    vocab_base: int = 0  # this rank's first vocabulary row
    inner: tuple = ()  # mamba's conv_inner channels


NO_SPLIT = Split()


def _split(rt: Runtime, d: ParamDef, dim: int) -> tuple:
    """The mesh axes of more than one rank on ``d``'s dim ``dim``, in its
    placement's order."""
    return tuple(a for a in mesh_axes(rt.placement(d)[dim])
                 if rt.mesh.shape[a] > 1)


def tp_layout(cfg: ModelConfig, rt: Runtime | None) -> Split:
    """The ``Split`` of ``cfg``'s attention, MLP, vocabulary and (hybrid)
    mamba channels under ``rt``. A layout the model code cannot run on
    raises: query heads that the model axis does not divide, or whole
    k/v weights beside split query heads."""
    if rt is None or rt.mesh is None:
        return NO_SPLIT
    tok = embed_defs(cfg)["tok"]
    vocab = _split(rt, tok, 0)
    kw = dict(mesh=rt.mesh, vocab=vocab,
              vocab_base=rt.block(tok)[0][0] if vocab else 0)
    if cfg.num_heads:
        ad = attention_defs(cfg)
        wq, wk = ad["wq"], ad["wk"]
        heads = _split(rt, wq, 1)
        if _split(rt, wq, 2):
            raise NotImplementedError(
                f"{cfg.name}: {cfg.num_heads} query heads do not split over "
                f"{rt.placement(wq)[2]!r}; head_dim-parallel queries are not "
                f"ported")
        kv, hd = _split(rt, wk, 1), _split(rt, wk, 2)
        if heads and not (kv or hd) or (kv and kv != heads) or (
                hd and hd != heads):
            raise NotImplementedError(
                f"{cfg.name}: query heads over {heads}, kv heads over {kv}, "
                f"kv head_dim over {hd}")
        kw["heads"] = heads
        if hd:
            H, KV = cfg.num_heads, cfg.num_kv_heads
            G = H // KV
            h_loc = rt.block_shape(wq)[1]
            q0 = rt.block(wq)[1][0]
            if not (h_loc % G == 0 or G % h_loc == 0):
                raise NotImplementedError(
                    f"{cfg.name}: {h_loc} query heads a rank straddle groups "
                    f"of {G}")
            kw.update(kv_gather=hd, kv_sel=(q0 // G, max(h_loc // G, 1)))
    mlp = mlp_defs(cfg)
    kw["mlp"] = _split(rt, mlp["wi" if "wi" in mlp else "wg"], 1)
    if cfg.family == "hybrid":
        from repro_torch.models.mamba import mamba_defs

        kw["inner"] = _split(rt, mamba_defs(cfg)["in_proj"], 1)
    return Split(**kw)


# ---------------------------------------------------------------------------
# parameter defs
# ---------------------------------------------------------------------------

def attention_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    defs = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", "head_dim"), init="fan_in"),
        "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed"), init="fan_in"),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), init="ones")
        defs["k_norm"] = ParamDef((hd,), (None,), init="ones")
    return defs


def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict[str, ParamDef]:
    """Ungated MLP for "gelu_plain" (whisper), else the gated one
    (SwiGLU / GeGLU: ``act(x wg) * (x wu)``, then ``wd``)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.activation == "gelu_plain":
        return {
            "wi": ParamDef((d, f), ("embed", "mlp"), init="fan_in"),
            "wo": ParamDef((f, d), ("mlp", "embed"), init="fan_in"),
        }
    return {
        "wg": ParamDef((d, f), ("embed", "mlp"), init="fan_in"),
        "wu": ParamDef((d, f), ("embed", "mlp"), init="fan_in"),
        "wd": ParamDef((f, d), ("mlp", "embed"), init="fan_in"),
    }


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig,
              tp: Split = NO_SPLIT) -> torch.Tensor:
    """The MLP on this rank's block of its hidden width: column then row
    parallel over ``tp.mlp``."""
    f = act_fn(cfg.activation)
    x = C.copy_in(x, tp.mlp, tp.mesh)
    if cfg.activation == "gelu_plain":
        y = f(x @ p["wi"].to(x.dtype)) @ p["wo"].to(x.dtype)
    else:
        g = x @ p["wg"].to(x.dtype)
        u = x @ p["wu"].to(x.dtype)
        y = (f(g) * u) @ p["wd"].to(x.dtype)
    return C.reduce_out(y, tp.mlp, tp.mesh)


def cross_attention_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    return attention_defs(cfg.replace(qk_norm=False))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bld,dhk->blhk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _out_proj(o: torch.Tensor, w: torch.Tensor, tp: Split = NO_SPLIT
              ) -> torch.Tensor:
    """einsum("blhk,hkd->bld") as one matrix product, summed over the
    ranks that split the heads (row parallel)."""
    h, k, d = w.shape
    y = o.flatten(-2) @ w.to(o.dtype).reshape(h * k, d)
    return C.reduce_out(y, tp.heads, tp.mesh)


def _kv_proj(x: torch.Tensor, w: torch.Tensor, tp: Split) -> torch.Tensor:
    """k or v of this rank: its KV heads, or the whole heads gathered over
    a split head_dim."""
    return C.gather_in(_proj_heads(x, w), tp.kv_gather, tp.mesh, -1)


def _qkv(p, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor | None = None, tp: Split = NO_SPLIT):
    """q, k, v (B, L, heads, hd) of this rank's heads; rotary embeddings on
    q and k at ``positions`` (B or 1, L) when given. ``x`` has entered the
    heads' ranks (``copy_in``)."""
    q = _proj_heads(x, p["wq"])
    k = _kv_proj(x, p["wk"], tp)
    v = _kv_proj(x, p["wv"], tp)
    if cfg.qk_norm:
        # the norms' scales see this rank's heads: their gradients sum
        q = rms_norm(q, C.copy_in(p["q_norm"], tp.heads, tp.mesh), cfg.norm_eps)
        k = rms_norm(k, C.copy_in(p["k_norm"], tp.heads, tp.mesh), cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _read(kv: torch.Tensor, tp: Split) -> torch.Tensor:
    """The KV heads of a whole k or v (B, L, KV, hd) that this rank's
    query heads use."""
    if tp.kv_sel is None:
        return kv
    return kv.narrow(2, *tp.kv_sel)


def _group(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B, L, H, D) -> (B, L, KV, G, D) grouped query layout."""
    B, L, H, D = q.shape
    return q.reshape(B, L, kv_heads, H // kv_heads, D)


def full_attention(q, k, v, *, causal: bool, q_offset: int = 0, kv_mask=None):
    """Direct attention. q: (B, Lq, H, D), k/v: (B, Lk, KV, D). ``kv_mask``
    (B, Lk) bool gates invalid key positions."""
    B, Lq, H, D = q.shape
    KV = k.shape[2]
    qg = _group(q, KV)
    scores = torch.einsum("blkgd,bmkd->bkglm", qg, k).float() * D ** -0.5
    if causal:
        qpos = torch.arange(Lq, device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = scores.masked_fill(~mask, NEG_INF)
    if kv_mask is not None:
        scores = scores.masked_fill(~kv_mask[:, None, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkglm,bmkd->blkgd", w, v)
    return out.reshape(B, Lq, H, D)


def chunked_attention(q, k, v, *, causal: bool, chunk: int, kv_mask=None):
    """Flash-style attention: loop over KV chunks with an online softmax.
    q: (B, Lq, H, D); k/v: (B, Lk, KV, D); lengths that are not a multiple
    of the chunk are padded inside (padded KV masked, padded Q trimmed)."""
    B, Lq0, H, D = q.shape
    Lk0 = k.shape[1]
    pad_q = (-Lq0) % min(chunk, Lq0)
    pad_k = (-Lk0) % min(chunk, Lk0)
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        base = torch.arange(Lk0 + pad_k, device=q.device)[None, :] < Lk0
        if kv_mask is not None:
            kv_mask = F.pad(kv_mask, (0, pad_k)) & base
        else:
            kv_mask = base.expand(B, Lk0 + pad_k)
    Lq, Lk, KV = q.shape[1], k.shape[1], k.shape[2]
    G = H // KV
    cq, ck = min(chunk, Lq), min(chunk, Lk)
    nq, nk = Lq // cq, Lk // ck
    scale = D ** -0.5
    qg = _group(q, KV).reshape(B, nq, cq, KV, G, D)
    kc = k.reshape(B, nk, ck, KV, D)
    vc = v.reshape(B, nk, ck, KV, D)
    outs = []
    for qi in range(nq):
        q_chunk = qg[:, qi]
        m = torch.full((B, KV, G, cq), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, cq), device=q.device)
        acc = torch.zeros((B, cq, KV, G, D), device=q.device)
        for kj in range(nk):
            s = torch.einsum("blkgd,bmkd->bkglm", q_chunk, kc[:, kj]).float() * scale
            if causal:
                qpos = qi * cq + torch.arange(cq, device=q.device)
                kpos = kj * ck + torch.arange(ck, device=q.device)
                s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_INF)
            if kv_mask is not None:
                mblk = kv_mask[:, kj * ck : (kj + 1) * ck]
                s = s.masked_fill(~mblk[:, None, None, None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                               torch.zeros_like(m))
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkglm,bmkd->blkgd", p.to(q.dtype), vc[:, kj]).float()
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        l_safe = torch.where(l > 0, l, torch.ones_like(l))
        outs.append((acc / l_safe.permute(0, 3, 1, 2)[..., None]).to(q.dtype))
    out = torch.stack(outs, dim=1).reshape(B, Lq, H, D)
    return out[:, :Lq0]


def self_attention(p, x: torch.Tensor, cfg: ModelConfig, *, causal: bool,
                   positions: torch.Tensor | None = None,
                   tp: Split = NO_SPLIT):
    """Self-attention over a whole sequence (encoder, prefill): the
    projected output, k and v (rotated where ``positions`` are given; this
    rank's KV heads, or all of them where ``tp`` gathers them). Full
    attention up to ``attn_chunk``, chunked past it."""
    x = C.copy_in(x, tp.heads, tp.mesh)
    q, k, v = _qkv(p, x, cfg, positions, tp)
    ka, va = _read(k, tp), _read(v, tp)
    if x.shape[1] > cfg.attn_chunk:
        o = chunked_attention(q, ka, va, causal=causal, chunk=cfg.attn_chunk)
    else:
        o = full_attention(q, ka, va, causal=causal)
    return _out_proj(o, p["wo"], tp), k, v


def attention_train(p, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor | None = None,
                    tp: Split = NO_SPLIT) -> torch.Tensor:
    """Causal self-attention over a full sequence (train): the projected
    output only; rotary embeddings at ``positions`` when given (jamba),
    none otherwise (whisper's decoder)."""
    return self_attention(p, x, cfg, causal=True, positions=positions,
                          tp=tp)[0]


def dequant_cache_leaf(cache: dict, name: str, dtype) -> torch.Tensor:
    """A cache leaf in ``dtype``, dequantized through its ``<name>_scale``
    sibling where the cache stores int8."""
    leaf = cache[name]
    scale = cache.get(f"{name}_scale")
    if scale is not None:
        return (leaf.float() * scale).to(dtype)
    return leaf.to(dtype)


def _read_cache(cache: dict, names: tuple, tp: Split) -> dict:
    """The cache leaves ``names`` (with any ``_scale`` siblings) at the KV
    heads this rank's query heads read: a whole cache (``tp.kv_sel``)
    narrowed to them, contiguous for the kernel."""
    out = {}
    for n in names:
        for key in (n, f"{n}_scale"):
            if key in cache:
                t = _read(cache[key], tp)
                out[key] = t if t.is_contiguous() else t.contiguous()
    return out


def attention_decode(p, x, cache: dict, pos: int, cfg: ModelConfig, *,
                     lengths: torch.Tensor | None = None, rope: bool = False,
                     tp: Split = NO_SPLIT):
    """Single-token decode step against a static KV cache.

    x: (B, 1, D); cache: {"k", "v": (B, S, KV, hd)}, with ``k_scale`` and
    ``v_scale`` (B, S, KV, 1) when it stores int8, updated in place at
    ``pos`` (this rank's KV heads, or all of them where ``tp`` gathers k
    and v); ``lengths`` (B,) int32 = pos + 1, made here when not given.
    ``rope``: q and the new k rotate at position ``pos`` (jamba).
    ``cfg.attn_decode`` "fused" reads the cache through the decode-attention
    kernel (an int8 cache as codes, its scales folded into the softmax);
    "view" is the direct softmax over the whole (dequantized) cache."""
    from repro_torch.models import common

    B = x.shape[0]
    positions = (torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
                 if rope else None)
    x = C.copy_in(x, tp.heads, tp.mesh)
    q, k_new, v_new = _qkv(p, x, cfg, positions, tp)
    for name, fresh in (("k", k_new), ("v", v_new)):
        common.store_kv_token(cache, name, fresh, pos)
    rd = _read_cache(cache, ("k", "v"), tp)
    if cfg.attn_decode == "fused":
        if lengths is None:
            lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
        out = ops.attention_decode(
            q[:, 0], rd["k"], rd["v"], lengths=lengths,
            k_scale=rd.get("k_scale"), v_scale=rd.get("v_scale"),
        ).to(x.dtype)[:, None]
    else:
        k = dequant_cache_leaf(rd, "k", x.dtype)
        v = dequant_cache_leaf(rd, "v", x.dtype)
        S, KV = k.shape[1], k.shape[2]
        qg = _group(q, KV)
        s = torch.einsum("blkgd,bmkd->bkglm", qg, k).float() * q.shape[-1] ** -0.5
        mask = torch.arange(S, device=x.device)[None, :] <= pos
        s = s.masked_fill(~mask[None, None, None], NEG_INF)
        w = torch.softmax(s, dim=-1).to(x.dtype)
        out = torch.einsum("bkglm,bmkd->blkgd", w, v).reshape(q.shape)
    return _out_proj(out, p["wo"], tp), cache


def cross_attention(p, x, enc_kv, cfg: ModelConfig, tp: Split = NO_SPLIT):
    """Decoder cross-attention over a whole sequence (prefill and train);
    enc_kv = precomputed (k, v) of the encoder output (``encode_kv``)."""
    x = C.copy_in(x, tp.heads, tp.mesh)
    q = _proj_heads(x, p["wq"])
    k, v = (_read(t, tp) for t in enc_kv)
    if x.shape[1] > cfg.attn_chunk:
        out = chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    else:
        out = full_attention(q, k, v, causal=False)
    return _out_proj(out, p["wo"], tp)


def cross_attention_decode(p, x, cache: dict, cfg: ModelConfig,
                           tp: Split = NO_SPLIT):
    """Single-token cross-attention against the cached encoder K/V
    (``xk``/``xv``, with ``_scale`` siblings when the cache stores int8),
    which is zero-padded past each slot's encoder length ``enc_len``
    (written at prefill): zero codes and zero scales in int8. A zero key
    scores 0, not -inf, so both reads mask on those ragged lengths; length
    0 attends nothing and gives 0."""
    dt = x.dtype
    x = C.copy_in(x, tp.heads, tp.mesh)
    q = _proj_heads(x, p["wq"])
    rd = _read_cache(cache, ("xk", "xv"), tp)
    if cfg.attn_decode == "fused":
        out = ops.attention_decode(
            q[:, 0], rd["xk"], rd["xv"],
            lengths=cache["enc_len"].to(torch.int32),
            k_scale=rd.get("xk_scale"), v_scale=rd.get("xv_scale"),
        ).to(dt)[:, None]
    else:
        xk = dequant_cache_leaf(rd, "xk", dt)
        xv = dequant_cache_leaf(rd, "xv", dt)
        S = xk.shape[1]
        valid = torch.arange(S, device=x.device)[None, :] < cache["enc_len"][:, None]
        # enc_len 0: attend every (zero) row so the softmax stays finite
        valid = valid | ~valid.any(dim=1, keepdim=True)
        out = full_attention(q, xk, xv, causal=False, kv_mask=valid)
    return _out_proj(out, p["wo"], tp)


def encode_kv(p, enc_out: torch.Tensor, cfg: ModelConfig,
              tp: Split = NO_SPLIT):
    """The cross-attention k and v of the encoder output: this rank's KV
    heads, or all of them where ``tp`` gathers them."""
    enc_out = C.copy_in(enc_out, tp.heads, tp.mesh)
    return _kv_proj(enc_out, p["wk"], tp), _kv_proj(enc_out, p["wv"], tp)


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------

def embed_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    defs = {
        "tok": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                        init="normal")
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"), init="normal")
    return defs


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig,
                 tp: Split = NO_SPLIT) -> torch.Tensor:
    """Token embeddings in the compute dtype; with ``cfg.embed_scale``
    (gemma) scaled by sqrt(d_model), the scale itself rounded to that
    dtype as the reference rounds it. Vocab-parallel under ``tp.vocab``:
    each rank looks up the tokens in its rows, zeros elsewhere, and the
    ranks' rows are summed."""
    tok = p["tok"]
    if tp.vocab:
        idx = tokens.long() - tp.vocab_base
        mine = (idx >= 0) & (idx < tok.shape[0])
        e = tok[idx.clamp(0, tok.shape[0] - 1)].to(cdtype(cfg))
        e = C.reduce_out(torch.where(mine[..., None], e, torch.zeros_like(e)),
                         tp.vocab, tp.mesh)
    else:
        e = tok[tokens.long()].to(cdtype(cfg))
    if cfg.embed_scale:
        e = e * torch.tensor(cfg.d_model ** 0.5, dtype=e.dtype, device=e.device)
    return e


def unembed_matrix(p, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return p["tok"].T
    return p["unembed"]


def lm_logits(p, h: torch.Tensor, cfg: ModelConfig,
              tp: Split = NO_SPLIT) -> torch.Tensor:
    """Logits summed in float32 from operands rounded to h's type, as the
    reference's ``preferred_element_type=f32``: this rank's vocabulary
    block under ``tp.vocab`` (``h`` enters its ranks)."""
    h = C.copy_in(h, tp.vocab, tp.mesh)
    w = unembed_matrix(p, cfg).to(h.dtype)
    return h.float() @ w.float()


def serve_logits(p, h: torch.Tensor, cfg: ModelConfig,
                 tp: Split = NO_SPLIT) -> torch.Tensor:
    """The whole vocabulary's logits of ``h`` (serving's last position):
    the ranks' blocks gathered over ``tp.vocab``, one gather a call."""
    return C.all_gather(lm_logits(p, h, cfg, tp), tp.vocab, tp.mesh, dim=-1)


def _ce_chunk(p_embed, hb: torch.Tensor, yb: torch.Tensor, cfg: ModelConfig,
              tp: Split = NO_SPLIT):
    """(sum of masked next-token CE, count of unmasked labels) of one chunk,
    from float32 logits. Under ``tp.vocab`` the logsumexp is the ranks':
    each sums the exponentials of its block past the ranks' max, and the
    gold logit comes from the rank whose block holds the label."""
    logits = lm_logits(p_embed, hb, cfg, tp)
    y = yb.clamp(min=0).long()
    if tp.vocab:
        m = C.pmax(logits.detach().amax(dim=-1), tp.vocab, tp.mesh)
        se = torch.exp(logits - m[..., None]).sum(dim=-1)
        logz = torch.log(C.reduce_out(se, tp.vocab, tp.mesh)) + m
        y = y - tp.vocab_base
        mine = (y >= 0) & (y < logits.shape[-1])
        g = torch.gather(logits, -1, y.clamp(0, logits.shape[-1] - 1)[..., None])
        gold = C.reduce_out(torch.where(mine, g[..., 0], torch.zeros_like(m)),
                            tp.vocab, tp.mesh)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y[..., None])[..., 0]
    mask = (yb >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_ce_sums(p_embed, h: torch.Tensor, labels: torch.Tensor,
                    cfg: ModelConfig, tp: Split = NO_SPLIT
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(summed next-token CE, count of labels that are not -1) over sequence
    chunks of ``cfg.loss_chunk``. Each chunk runs under
    ``torch.utils.checkpoint``, so its (B, c, V) logits are recomputed in
    backward and the logits of all chunks never exist at once. h: (B, L,
    D); labels: (B, L), -1 masked. As in the reference, rows past the last
    whole chunk are dropped."""
    L = h.shape[1]
    c = min(cfg.loss_chunk, L)
    tot = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for i in range(L // c):
        hb, yb = h[:, i * c : (i + 1) * c], labels[:, i * c : (i + 1) * c]
        if torch.is_grad_enabled():
            t, n = checkpoint(_ce_chunk, p_embed, hb, yb, cfg, tp,
                              use_reentrant=False)
        else:
            t, n = _ce_chunk(p_embed, hb, yb, cfg, tp)
        tot, cnt = tot + t, cnt + n
    return tot, cnt


def chunked_ce_loss(p_embed, h: torch.Tensor, labels: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token CE (``chunked_ce_sums``' sum over its count)."""
    tot, cnt = chunked_ce_sums(p_embed, h, labels, cfg)
    return tot / torch.clamp(cnt, min=1.0)
