"""Transformer building blocks on tensors (the whisper, jamba and dense /
llava subset of ``repro.models.layers``).

Conventions, as in the reference: activations in ``compute_dtype``;
reductions, softmax and norms in float32; grouped-query attention with
grouped einsums (no KV head repetition in memory); flash-style chunked
attention past ``attn_chunk``; decode against a static KV cache; logits
summed in float32; the training loss chunked over the sequence. Rotary
embeddings (jamba) rotate q and k in float32 where the caller passes
positions; whisper passes none and uses sinusoidal positions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import conv as core_conv
from repro_torch.distributed.sharding import ParamDef, torch_dtype
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
    the CUDA kernel's epilogue; the other backends apply them unfused.

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
    return ops.conv1d(
        x, w.to(x.dtype), stride=stride, padding=padding, backend=backend,
        bias=b, activation=activation,
    )


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


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    f = act_fn(cfg.activation)
    if cfg.activation == "gelu_plain":
        return f(x @ p["wi"].to(x.dtype)) @ p["wo"].to(x.dtype)
    g = x @ p["wg"].to(x.dtype)
    u = x @ p["wu"].to(x.dtype)
    return (f(g) * u) @ p["wd"].to(x.dtype)


def cross_attention_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    return attention_defs(cfg.replace(qk_norm=False))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bld,dhk->blhk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _out_proj(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("blhk,hkd->bld") as one matrix product."""
    h, k, d = w.shape
    return o.flatten(-2) @ w.to(o.dtype).reshape(h * k, d)


def _qkv(p, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor | None = None):
    """q, k, v (B, L, heads, hd); rotary embeddings on q and k at
    ``positions`` (B or 1, L) when given."""
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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
                   positions: torch.Tensor | None = None):
    """Self-attention over a whole sequence (encoder, prefill): the
    projected output, k and v (rotated where ``positions`` are given). Full
    attention up to ``attn_chunk``, chunked past it."""
    q, k, v = _qkv(p, x, cfg, positions)
    if x.shape[1] > cfg.attn_chunk:
        o = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    else:
        o = full_attention(q, k, v, causal=causal)
    return _out_proj(o, p["wo"]), k, v


def attention_train(p, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor | None = None) -> torch.Tensor:
    """Causal self-attention over a full sequence (train): the projected
    output only; rotary embeddings at ``positions`` when given (jamba),
    none otherwise (whisper's decoder)."""
    return self_attention(p, x, cfg, causal=True, positions=positions)[0]


def dequant_cache_leaf(cache: dict, name: str, dtype) -> torch.Tensor:
    """A cache leaf in ``dtype``, dequantized through its ``<name>_scale``
    sibling where the cache stores int8."""
    leaf = cache[name]
    scale = cache.get(f"{name}_scale")
    if scale is not None:
        return (leaf.float() * scale).to(dtype)
    return leaf.to(dtype)


def attention_decode(p, x, cache: dict, pos: int, cfg: ModelConfig, *,
                     lengths: torch.Tensor | None = None, rope: bool = False):
    """Single-token decode step against a static KV cache.

    x: (B, 1, D); cache: {"k", "v": (B, S, KV, hd)}, with ``k_scale`` and
    ``v_scale`` (B, S, KV, 1) when it stores int8, updated in place at
    ``pos``; ``lengths`` (B,) int32 = pos + 1, made here when not given.
    ``rope``: q and the new k rotate at position ``pos`` (jamba).
    ``cfg.attn_decode`` "fused" reads the cache through the decode-attention
    kernel (an int8 cache as codes, its scales folded into the softmax);
    "view" is the direct softmax over the whole (dequantized) cache."""
    from repro_torch.models import common

    B = x.shape[0]
    positions = (torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
                 if rope else None)
    q, k_new, v_new = _qkv(p, x, cfg, positions)
    for name, fresh in (("k", k_new), ("v", v_new)):
        common.store_kv_token(cache, name, fresh, pos)
    if cfg.attn_decode == "fused":
        if lengths is None:
            lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
        out = ops.attention_decode(
            q[:, 0], cache["k"], cache["v"], lengths=lengths,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
        ).to(x.dtype)[:, None]
    else:
        k = dequant_cache_leaf(cache, "k", x.dtype)
        v = dequant_cache_leaf(cache, "v", x.dtype)
        S, KV = k.shape[1], k.shape[2]
        qg = _group(q, KV)
        s = torch.einsum("blkgd,bmkd->bkglm", qg, k).float() * q.shape[-1] ** -0.5
        mask = torch.arange(S, device=x.device)[None, :] <= pos
        s = s.masked_fill(~mask[None, None, None], NEG_INF)
        w = torch.softmax(s, dim=-1).to(x.dtype)
        out = torch.einsum("bkglm,bmkd->blkgd", w, v).reshape(q.shape)
    return _out_proj(out, p["wo"]), cache


def cross_attention(p, x, enc_kv, cfg: ModelConfig):
    """Decoder cross-attention over a whole sequence (prefill and train);
    enc_kv = precomputed (k, v) of the encoder output."""
    q = _proj_heads(x, p["wq"])
    k, v = enc_kv
    if x.shape[1] > cfg.attn_chunk:
        out = chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    else:
        out = full_attention(q, k, v, causal=False)
    return _out_proj(out, p["wo"])


def cross_attention_decode(p, x, cache: dict, cfg: ModelConfig):
    """Single-token cross-attention against the cached encoder K/V
    (``xk``/``xv``, with ``_scale`` siblings when the cache stores int8),
    which is zero-padded past each slot's encoder length ``enc_len``
    (written at prefill): zero codes and zero scales in int8. A zero key
    scores 0, not -inf, so both reads mask on those ragged lengths; length
    0 attends nothing and gives 0."""
    dt = x.dtype
    q = _proj_heads(x, p["wq"])
    if cfg.attn_decode == "fused":
        out = ops.attention_decode(
            q[:, 0], cache["xk"], cache["xv"],
            lengths=cache["enc_len"].to(torch.int32),
            k_scale=cache.get("xk_scale"), v_scale=cache.get("xv_scale"),
        ).to(dt)[:, None]
    else:
        xk = dequant_cache_leaf(cache, "xk", dt)
        xv = dequant_cache_leaf(cache, "xv", dt)
        S = xk.shape[1]
        valid = torch.arange(S, device=x.device)[None, :] < cache["enc_len"][:, None]
        # enc_len 0: attend every (zero) row so the softmax stays finite
        valid = valid | ~valid.any(dim=1, keepdim=True)
        out = full_attention(q, xk, xv, causal=False, kv_mask=valid)
    return _out_proj(out, p["wo"])


def encode_kv(p, enc_out: torch.Tensor, cfg: ModelConfig):
    return _proj_heads(enc_out, p["wk"]), _proj_heads(enc_out, p["wv"])


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


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["tok"][tokens.long()].to(cdtype(cfg))


def unembed_matrix(p, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return p["tok"].T
    return p["unembed"]


def lm_logits(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits summed in float32 from operands rounded to h's type, as the
    reference's ``preferred_element_type=f32``."""
    w = unembed_matrix(p, cfg).to(h.dtype)
    return h.float() @ w.float()


def _ce_chunk(p_embed, hb: torch.Tensor, yb: torch.Tensor, cfg: ModelConfig):
    """(sum of masked next-token CE, count of unmasked labels) of one chunk,
    from float32 logits."""
    logits = lm_logits(p_embed, hb, cfg)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yb.clamp(min=0).long()[..., None])[..., 0]
    mask = (yb >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_ce_loss(p_embed, h: torch.Tensor, labels: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token CE over sequence chunks of ``cfg.loss_chunk``. Each
    chunk runs under ``torch.utils.checkpoint``, so its (B, c, V) logits
    are recomputed in backward and the logits of all chunks never exist at
    once. h: (B, L, D); labels: (B, L), -1 masked. As in the reference,
    rows past the last whole chunk are dropped."""
    L = h.shape[1]
    c = min(cfg.loss_chunk, L)
    tot = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for i in range(L // c):
        hb, yb = h[:, i * c : (i + 1) * c], labels[:, i * c : (i + 1) * c]
        if torch.is_grad_enabled():
            t, n = checkpoint(_ce_chunk, p_embed, hb, yb, cfg,
                              use_reentrant=False)
        else:
            t, n = _ce_chunk(p_embed, hb, yb, cfg)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)
