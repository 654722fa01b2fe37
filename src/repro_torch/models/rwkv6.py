"""RWKV6 "Finch" (arXiv:2404.05892): an attention-free LM with data-dependent
decay (``repro.models.rwkv6``).

The token shift is the paper's sliding window of width 2: each block reads
its input beside a one-step shifted view of it (``token_shift``), never a
gathered buffer.

WKV evaluation, as in the reference:
  * ``wkv_mode="scan"``: the recurrence ``S_t = diag(w_t) S_{t-1} +
    k_t^T v_t`` one position at a time (``wkv_scan``; every decode step);
  * ``wkv_mode="chunked"``: the chunkwise parallel form, masked (c x c)
    products inside a chunk and the state carried between chunks
    (``wkv_chunked``; the published config's prefill and training). Each
    chunk runs under ``torch.utils.checkpoint`` when grad is enabled, so
    its (B, c, c, H, K) float32 intra-chunk tensors are recomputed in
    backward, not kept for every chunk of every layer.

The model has no kernel of its own: it is plain PyTorch. Parameters are
stacked per layer (the reference's pytree: same paths and shapes). The
serving state per layer is the WKV state (B, H, K, K) float32 and the two
token-shift carries (B, 1, d), O(1) in the sequence length: the cache has
no ``kv_seq`` axis.

On a mesh it runs data-parallel only: a runtime that would split any of
its leaves (over ``model``, or ``embed`` under ``FSDP_RULES``) raises.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    ParamDef, Runtime, init_params, iter_leaves,
)
from repro_torch.models import layers as L
from repro_torch.models.common import (
    global_mean, layer, scan_blocks, stack_defs,
)

LORA_R = 32  # ddlerp LoRA rank
DECAY_R = 64  # decay LoRA rank
WKV_CHUNK = 32


def _heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def block_defs(cfg: ModelConfig) -> dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    H, K = _heads(cfg), cfg.rwkv_head_dim
    return {
        "ln1": ParamDef((d,), ("embed",), init="ones"),
        "ln2": ParamDef((d,), ("embed",), init="ones"),
        # time mix (the attention analogue)
        "tm_maa_x": ParamDef((d,), ("embed",), init="zeros"),
        "tm_maa": ParamDef((5, d), (None, "embed"), init="zeros"),  # w,k,v,r,g
        "tm_A": ParamDef((d, 5 * LORA_R), ("embed", None), init="small"),
        "tm_B": ParamDef((5, LORA_R, d), (None, None, "embed"), init="small"),
        "decay_base": ParamDef((d,), ("embed",), init="zeros"),
        "decay_A": ParamDef((d, DECAY_R), ("embed", None), init="small"),
        "decay_B": ParamDef((DECAY_R, d), (None, "embed"), init="small"),
        "bonus": ParamDef((H, K), ("heads", None), init="small"),
        "wr": ParamDef((d, d), ("embed", "heads_flat"), init="fan_in"),
        "wk": ParamDef((d, d), ("embed", "heads_flat"), init="fan_in"),
        "wv": ParamDef((d, d), ("embed", "heads_flat"), init="fan_in"),
        "wg": ParamDef((d, d), ("embed", "heads_flat"), init="fan_in"),
        "wo": ParamDef((d, d), ("heads_flat", "embed"), init="fan_in"),
        "gn_scale": ParamDef((d,), ("embed",), init="ones"),
        # channel mix
        "cm_maa_k": ParamDef((d,), ("embed",), init="zeros"),
        "cm_maa_r": ParamDef((d,), ("embed",), init="zeros"),
        "cm_wk": ParamDef((d, f), ("embed", "mlp"), init="fan_in"),
        "cm_wv": ParamDef((f, d), ("mlp", "embed"), init="fan_in"),
        "cm_wr": ParamDef((d, d), ("embed", "embed"), init="fan_in"),
    }


# ---------------------------------------------------------------------------
# the sliding-window token shift (window 2)
# ---------------------------------------------------------------------------

def token_shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """The x_{t-1} view of x (B, L, d): ``prev`` (B, 1, d), the decode
    carry, or zeros, then x without its last position."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(x, xs, maa_x, maa, A, Bm):
    """The data-dependent lerp giving the five mixed inputs (w, k, v, r, g),
    stacked (5, B, L, d)."""
    base = x + (xs - x) * maa_x
    lora = torch.tanh(base @ A.to(x.dtype)).reshape(*x.shape[:2], 5, LORA_R)
    dd = torch.einsum("blfr,frd->fbld", lora, Bm.to(x.dtype))
    mix = maa[:, None, None, :] + dd
    return x[None] + (xs - x)[None] * mix


# ---------------------------------------------------------------------------
# WKV evaluation
# ---------------------------------------------------------------------------

def wkv_scan(r, k, v, logw, u, state):
    """The sequential recurrence. r, k, logw: (B, L, H, K); v: (B, L, H,
    V); u: (H, K); state: (B, H, K, V) float32. Returns (out (B, L, H, V)
    float32, state)."""
    r, k, v, logw = (t.float() for t in (r, k, v, logw))
    S, outs = state, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 S + u[None, :, :, None] * kv))
        S = torch.exp(logw[:, t])[..., None] * S + kv
    return torch.stack(outs, dim=1), S


def _wkv_chunk(S, rb, kb, vb, lwb, u, mask):
    """One chunk of ``wkv_chunked``: (state after it, its output)."""
    cum = torch.cumsum(lwb, dim=1)  # (B, c, H, K)
    cum_prev = cum - lwb  # exclusive, <= 0: stable
    o_inter = torch.einsum("bchk,bhkv->bchv", rb * torch.exp(cum_prev), S)
    # pairwise decay inside the chunk: cum_prev_i - cum_j <= 0 for j < i
    # (strictly masked), so the exp never overflows
    diff = cum_prev[:, :, None] - cum[:, None, :]  # (B, c, c, H, K)
    dec = torch.exp(diff.masked_fill(~mask[None, :, :, None, None],
                                     float("-inf")))
    A = torch.einsum("bchk,bdhk->bcdhk", rb, kb)
    A = torch.einsum("bcdhk->bhcd", A * dec)
    diag = torch.einsum("bchk,hk,bchk->bch", rb, u, kb)
    o_intra = torch.einsum("bhcd,bdhv->bchv", A, vb) + diag[..., None] * vb
    # S' = diag(P_end) S + sum_j P_end / P_j k_j v_j
    p_end = torch.exp(cum[:, -1])  # (B, H, K)
    k_tail = kb * torch.exp(cum[:, -1:] - cum)
    S = p_end[..., None] * S + torch.einsum("bchk,bchv->bhkv", k_tail, vb)
    return S, o_inter + o_intra


def wkv_chunked(r, k, v, logw, u, state, chunk: int = WKV_CHUNK):
    """The chunkwise parallel WKV, the semantics of ``wkv_scan``. The chunk
    is ``min(chunk, L)``, as in the reference, so L must be a whole number
    of chunks when it exceeds one: the reference fails there inside an
    einsum, this raises ``ValueError``."""
    B, Lt, H, K = r.shape
    V = v.shape[-1]
    c = min(chunk, Lt)
    n = Lt // c
    if n * c != Lt:
        raise ValueError(
            f"wkv_chunked: {Lt} positions are not a whole number of "
            f"{c}-position chunks; a sequence longer than the chunk must be "
            f"a multiple of it")
    rc, kc, vc, wc = (t.float().reshape(B, n, c, H, -1)
                      for t in (r, k, v, logw))
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    ckpt = torch.is_grad_enabled()
    S, outs = state.float(), []
    for i in range(n):
        args = (S, rc[:, i], kc[:, i], vc[:, i], wc[:, i], u, mask)
        S, o = (checkpoint(_wkv_chunk, *args, use_reentrant=False) if ckpt
                else _wkv_chunk(*args))
        outs.append(o)
    return torch.cat(outs, dim=1).reshape(B, Lt, H, V), S


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def time_mix(lp, x: torch.Tensor, cfg: ModelConfig, state, x_prev=None,
             wkv_mode: str = "scan"):
    """The time mix of one block on x (B, L, d) from the WKV ``state``
    (B, H, K, K) float32 and the token-shift carry ``x_prev``: (output
    (B, L, d), state after the last position)."""
    B, Lt, d = x.shape
    H, K = _heads(cfg), cfg.rwkv_head_dim
    dt = x.dtype
    xs = token_shift(x, x_prev)
    mw, mk, mv, mr, mg = _ddlerp(x, xs, lp["tm_maa_x"].to(dt),
                                 lp["tm_maa"].to(dt), lp["tm_A"], lp["tm_B"])
    r = (mr @ lp["wr"].to(dt)).reshape(B, Lt, H, K)
    kk = (mk @ lp["wk"].to(dt)).reshape(B, Lt, H, K)
    vv = (mv @ lp["wv"].to(dt)).reshape(B, Lt, H, K)
    g = F.silu(mg @ lp["wg"].to(dt))
    # the decay LoRA in the compute type, upcast only at the exp
    dec_lora = torch.tanh(mw @ lp["decay_A"].to(dt)) @ lp["decay_B"].to(dt)
    dec = lp["decay_base"].float() + dec_lora.float()
    logw = -torch.exp(torch.clamp(dec, -10.0, 4.0)).reshape(B, Lt, H, K)
    u = lp["bonus"].float()
    if wkv_mode == "chunked":
        out, state = wkv_chunked(r, kk, vv, logw, u, state,
                                 chunk=cfg.rwkv_wkv_chunk)
    else:
        out, state = wkv_scan(r, kk, vv, logw, u, state)
    # group norm per head
    mean = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = (out - mean) * torch.rsqrt(var + 64e-5)
    out = out.reshape(B, Lt, d).to(dt) * lp["gn_scale"].to(dt)
    return (out * g) @ lp["wo"].to(dt), state


def channel_mix(lp, x: torch.Tensor, cfg: ModelConfig, x_prev=None):
    """The channel mix (squared-relu FFN gated by a sigmoid) on x (B, L, d)
    with the token-shift carry ``x_prev``."""
    dt = x.dtype
    xs = token_shift(x, x_prev)
    xk = x + (xs - x) * lp["cm_maa_k"].to(dt)
    xr = x + (xs - x) * lp["cm_maa_r"].to(dt)
    kk = torch.square(torch.relu(xk @ lp["cm_wk"].to(dt)))
    vv = kk @ lp["cm_wv"].to(dt)
    return torch.sigmoid(xr @ lp["cm_wr"].to(dt)) * vv


class RWKV6:
    def __init__(self, cfg: ModelConfig, rt: Runtime | None = None,
                 wkv_mode: str = "scan"):
        self.cfg = cfg
        self.rt = rt or Runtime()
        self.wkv_mode = wkv_mode
        split = sorted(p for p, d in iter_leaves(self.param_defs())
                       if self.rt.split_axes(d))
        if split:
            raise NotImplementedError(
                f"rwkv6 on a mesh that splits {len(split)} of its leaves "
                f"({split[0]}, ...): its heads_flat tensor parallelism is "
                f"not ported (ROADMAP Queue 1 item 6, rwkv6's heads_flat); "
                f"data parallelism with a model axis of one rank runs")

    def param_defs(self) -> dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": L.embed_defs(cfg),
            "blocks": stack_defs(block_defs(cfg), cfg.num_layers),
            "final_norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        }

    def init(self, gen: torch.Generator):
        """Random parameters from ``gen``, on ``gen``'s device."""
        return init_params(self.param_defs(), gen, self.cfg.param_dtype,
                           self.rt)

    def _state0(self, x: torch.Tensor) -> torch.Tensor:
        K = self.cfg.rwkv_head_dim
        return torch.zeros((x.shape[0], _heads(self.cfg), K, K),
                           dtype=torch.float32, device=x.device)

    def _layer(self, x, lp):
        """One block from a zero state: (x out, the block's serving state)."""
        cfg = self.cfg
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, S = time_mix(lp, h, cfg, self._state0(x), wkv_mode=self.wkv_mode)
        x = x + y
        h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + channel_mix(lp, h2, cfg)
        return x, {"wkv": S, "tm_prev": h[:, -1:], "cm_prev": h2[:, -1:]}

    def _block(self, x, lp):
        return self._layer(x, lp)[0]

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token CE of ``batch["labels"]`` (-1 masked), over the
        whole batch with data ranks. Each block runs under
        ``torch.utils.checkpoint`` when ``cfg.remat`` is not "none" and grad
        is enabled."""
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
        x = scan_blocks(x, params["blocks"], self._block,
                        remat=cfg.remat != "none")
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return global_mean(*L.chunked_ce_sums(params["embed"], x,
                                              batch["labels"], cfg), self.rt)

    # -- serving ------------------------------------------------------------------
    def cache_defs(self, batch: int, seq: int):
        """The recurrent state, O(1) in the sequence length (``seq`` is not
        used): per layer the WKV state float32 and the two token-shift
        carries in the param dtype. ``kv_quant`` does not apply."""
        cfg = self.cfg
        H, K = _heads(cfg), cfg.rwkv_head_dim
        nl, d = cfg.num_layers, cfg.d_model
        return {
            "wkv": ParamDef((nl, batch, H, K, K),
                            ("layers", "batch", "heads", None, None),
                            init="zeros", dtype="float32"),
            "tm_prev": ParamDef((nl, batch, 1, d),
                                ("layers", "batch", None, "embed"),
                                init="zeros"),
            "cm_prev": ParamDef((nl, batch, 1, d),
                                ("layers", "batch", None, "embed"),
                                init="zeros"),
        }

    def prefill(self, params, batch, *, record: list | None = None):
        """The prompt's forward: last-position logits (B, 1, V) float32 and
        the recurrent state of every layer ({wkv, tm_prev, cm_prev}, stacked
        per layer; the carries in the compute type). ``record``, when given,
        receives max |x| of the residual stream after each layer."""
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg)

        def body(xc, lp):
            xc, state = self._layer(xc, lp)
            if record is not None:
                record.append(xc.abs().max().item())
            return xc, state

        x, cache = scan_blocks(x, params["blocks"], body,
                               remat=cfg.remat != "none", collect=True)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return L.lm_logits(params["embed"], x[:, -1:], cfg), cache

    def decode_step(self, params, cache, tokens: torch.Tensor, pos: int):
        """One token for every slot: logits (B, 1, V) float32. The WKV
        evaluation is the scan, as in the reference; the state does not
        depend on ``pos``. Each layer's state is written in place and the
        cache returned."""
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], tokens, cfg)
        for i in range(cfg.num_layers):
            lp, cl = layer(params["blocks"], i), layer(cache, i)
            h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            y, S = time_mix(lp, h, cfg, cl["wkv"],
                            x_prev=cl["tm_prev"].to(h.dtype), wkv_mode="scan")
            x = x + y
            h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + channel_mix(lp, h2, cfg, x_prev=cl["cm_prev"].to(h2.dtype))
            cl["wkv"].copy_(S)
            cl["tm_prev"].copy_(h)
            cl["cm_prev"].copy_(h2)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return L.lm_logits(params["embed"], x, cfg), cache
