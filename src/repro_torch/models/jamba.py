"""Jamba hybrid (arXiv:2403.19887): Mamba and attention interleaved 7:1,
with MoE (``repro.models.jamba``).

Layer schedule (period ``attn_every`` = 8): position 4 is attention
(grouped queries, rotary embeddings), the other 7 are Mamba blocks; every
other position (odd ones) swaps the dense gated MLP for the MoE FFN when
the config has experts. Parameters are stacked per period, the reference's
pytree (same paths and shapes), and the periods run as a loop.

Serving state per period: one attention KV cache (float, or int8 codes
with per-row scales under ``cfg.kv_quant == "int8"``) and seven Mamba
``{conv, ssm}`` states. ``decode_step`` updates the cache in place.

The serving path through the kernels: with ``conv_backend ==
"sliding_pallas"`` every Mamba block's prefill conv is one launch of the
depthwise conv kernel (the int8 depthwise kernel under ``conv_precision ==
"w8a8"``), and every decode step's attention read is one launch of the
decode-attention kernel per period.

Training (``hidden``, ``loss``): each layer position runs under
``torch.utils.checkpoint`` when ``cfg.remat`` is not "none" (the
reference's ``jax.checkpoint`` per position), and the loss is the chunked
cross-entropy plus ``0.01 · aux / num_layers``, aux the MoE layers'
load-balancing loss. Through ``sliding_pallas`` every Mamba conv trains on
the kernels: the forward depthwise kernel with the saved pre-activation
(again in the recompute), dx through the same kernel, dw and db through
the depthwise dw kernel.

On a mesh (``rt``) the attention layer and the dense FFN are tensor-
parallel over the model axis and the mamba layers over their channels
(``layers.Split``; ``mamba``'s docstring), the MoE FFN expert-parallel;
under ``FSDP_RULES`` each layer position's ``embed`` blocks are gathered
at its start. The cache holds the rank's KV heads and channels.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    ParamDef, Runtime, init_params, torch_dtype,
)
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (
    data_mean, gatherer, global_mean, kv_scale_defs, layer, local_kv_heads,
    stack_defs, strip_kv_prefix, unstack,
)
from repro_torch.models.mamba import mamba_apply, mamba_defs, mamba_state_defs


def _attn_pos(cfg: ModelConfig) -> int:
    return cfg.attn_every // 2  # attention sits mid-period (jamba: 4)


def _stack(items: list) -> Any:
    """Stack a list of equally shaped nested dicts of tensors leaf by leaf
    along a new leading axis."""
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return torch.stack(items)


class Jamba:
    def __init__(self, cfg: ModelConfig, rt: Runtime | None = None):
        if not (cfg.attn_every > 0 and cfg.num_layers % cfg.attn_every == 0):
            raise ValueError(f"num_layers {cfg.num_layers} is not a multiple "
                             f"of attn_every {cfg.attn_every}")
        self.cfg = cfg
        self.rt = rt or Runtime()
        self.period = cfg.attn_every
        self.n_periods = cfg.num_layers // cfg.attn_every
        self.tp = L.tp_layout(cfg, self.rt)
        self._gathers = [gatherer(self._pos_defs(j), self.rt)
                         for j in range(self.period)]
        self._gather_top = gatherer(
            {k: v for k, v in self.param_defs().items() if k != "periods"},
            self.rt)

    def _whole(self, params):
        """``params`` with the leaves outside the periods gathered where
        FSDP splits them (the periods gather position by position)."""
        if self._gather_top is None:
            return params
        top = self._gather_top({k: v for k, v in params.items()
                                if k != "periods"})
        return dict(top, periods=params["periods"])

    def _pos(self, pp, j: int):
        """Position ``j``'s leaves of one period, gathered where FSDP
        splits them."""
        g = self._gathers[j]
        return pp[f"pos{j}"] if g is None else g(pp[f"pos{j}"])

    # -- parameters -------------------------------------------------------------
    def _pos_defs(self, pos: int) -> dict[str, Any]:
        cfg = self.cfg
        d = {"norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
             "ffn_norm": ParamDef((cfg.d_model,), ("embed",), init="ones")}
        if pos == _attn_pos(cfg):
            d["attn"] = L.attention_defs(cfg)
        else:
            d["mamba"] = mamba_defs(cfg)
        if cfg.num_experts and pos % cfg.moe_every == 1:
            d["moe"] = moe_lib.moe_defs(cfg)
        else:
            d["mlp"] = L.mlp_defs(cfg)
        return d

    def param_defs(self):
        cfg = self.cfg
        return {
            "embed": L.embed_defs(cfg),
            "periods": {
                f"pos{j}": stack_defs(self._pos_defs(j), self.n_periods)
                for j in range(self.period)
            },
            "final_norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        }

    def init(self, gen: torch.Generator):
        """Random parameters from ``gen``, on ``gen``'s device (this rank's
        blocks on a mesh)."""
        return init_params(self.param_defs(), gen, self.cfg.param_dtype,
                           self.rt)

    # -- training -----------------------------------------------------------------
    def _pos_block(self, x, aux, lp, pos: int):
        """One layer position: (x, aux) -> (x, aux), aux summing the MoE
        layers' load-balancing losses (float32)."""
        cfg = self.cfg
        g = self._gathers[pos]
        if g is not None:
            lp = g(lp)
        h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
        if pos == _attn_pos(cfg):
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
            x = x + L.attention_train(lp["attn"], h, cfg, positions=positions,
                                      tp=self.tp)
        else:
            x = x + mamba_apply(lp["mamba"], h, cfg, tp=self.tp)[0]
        h = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        if "moe" in lp:
            y, a = moe_lib.moe_apply(lp["moe"], h, cfg, self.rt)
            aux = aux + a
        else:
            y = L.mlp_apply(lp["mlp"], h, cfg, self.tp)
        return x + y, aux

    def hidden(self, params, embeds):
        """The periods over the embedded tokens: (final-normed hidden
        states, aux)."""
        cfg = self.cfg
        ckpt = cfg.remat != "none" and torch.is_grad_enabled()
        x = embeds
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for pp in unstack(params["periods"]):
            for j in range(self.period):
                args = (x, aux, pp[f"pos{j}"], j)
                x, aux = (checkpoint(self._pos_block, *args,
                                     use_reentrant=False)
                          if ckpt else self._pos_block(*args))
        return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token CE of ``batch["labels"]`` (-1 masked) given
        ``batch["tokens"]``, plus ``0.01 · aux / num_layers``: a float32
        scalar."""
        cfg = self.cfg
        params = self._whole(params)
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg, self.tp)
        h, aux = self.hidden(params, x)
        ce = global_mean(*L.chunked_ce_sums(params["embed"], h,
                                            batch["labels"], cfg, self.tp),
                         self.rt)
        return ce + 0.01 * data_mean(aux, self.rt) / max(cfg.num_layers, 1)

    # -- serving ------------------------------------------------------------------
    def cache_defs(self, batch: int, seq: int):
        cfg = self.cfg
        kv, hd = local_kv_heads(cfg, self.rt), cfg.resolved_head_dim
        dt = "int8" if cfg.kv_quant == "int8" else None  # None: param dtype
        axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        shape = (self.n_periods, batch, seq, kv, hd)
        d = {"attn_k": ParamDef(shape, axes, init="zeros", dtype=dt),
             "attn_v": ParamDef(shape, axes, init="zeros", dtype=dt)}
        if dt:
            d.update(kv_scale_defs(dict(d)))
        states = mamba_state_defs(cfg, self.n_periods, batch, self.rt)
        for j in range(self.period):
            if j != _attn_pos(cfg):
                d[f"mamba{j}"] = states
        return d

    def _ffn(self, lp, h):
        if "moe" in lp:
            return moe_lib.moe_apply(lp["moe"], h, self.cfg, self.rt)[0]
        return L.mlp_apply(lp["mlp"], h, self.cfg, self.tp)

    def prefill(self, params, batch, *, record: list | None = None):
        """Prompt forward: last-token logits (B, 1, V) float32 and the
        serving state {attn_k, attn_v: (periods, B, P, KV, hd), mamba{j}:
        {conv: (periods, B, K-1, di), ssm: (periods, B, di, N)}}. ``record``,
        when given, receives max |x| of the residual stream after each layer
        (one host read per layer)."""
        cfg, tp = self.cfg, self.tp
        params = self._whole(params)
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg, tp)
        B, P = x.shape[:2]
        positions = torch.arange(P, device=x.device)[None, :]
        pd = torch_dtype(cfg.param_dtype)
        caches = []
        for i in range(self.n_periods):
            pp = layer(params["periods"], i)
            out = {}
            for j in range(self.period):
                lp = self._pos(pp, j)
                h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
                if j == _attn_pos(cfg):
                    y, k, v = L.self_attention(lp["attn"], h, cfg, causal=True,
                                               positions=positions, tp=tp)
                    out["attn_k"], out["attn_v"] = k.to(pd), v.to(pd)
                else:
                    y, out[f"mamba{j}"] = mamba_apply(lp["mamba"], h, cfg,
                                                      return_state=True, tp=tp)
                x = x + y
                x = x + self._ffn(lp, L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps))
                if record is not None:
                    record.append(x.abs().max().item())
            caches.append(out)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return (L.serve_logits(params["embed"], x[:, -1:], cfg, tp),
                _stack(caches))

    def decode_step(self, params, cache, tokens: torch.Tensor, pos: int):
        """One token for every slot at position ``pos``: logits (B, 1, V)
        float32. The cache (with its ``_scale`` leaves when int8) is updated
        in place and returned."""
        cfg, tp = self.cfg, self.tp
        params = self._whole(params)
        x = L.embed_tokens(params["embed"], tokens, cfg, tp)
        B = x.shape[0]
        lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
        for i in range(self.n_periods):
            pp = layer(params["periods"], i)
            cl = layer(cache, i)
            for j in range(self.period):
                lp = self._pos(pp, j)
                h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
                if j == _attn_pos(cfg):
                    # the attn_ leaves as a set, the int8 cache's (codes,
                    # scale) pairs together; written in place
                    y, _ = L.attention_decode(
                        lp["attn"], h, strip_kv_prefix(cl, "attn_"), pos, cfg,
                        lengths=lengths, rope=True, tp=tp)
                else:
                    st = cl[f"mamba{j}"]
                    y, new = mamba_apply(lp["mamba"], h, cfg, state=st, tp=tp)
                    st["conv"].copy_(new["conv"])
                    st["ssm"].copy_(new["ssm"])
                x = x + y
                x = x + self._ffn(lp, L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps))
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return L.serve_logits(params["embed"], x, cfg, tp), cache
