"""Dense / MoE decoder-only LM (qwen3, llama3, gemma, granite, qwen3-moe,
phi3.5-moe, and the llava backbone): ``repro.models.transformer``.

Pre-norm blocks, grouped-query attention with rotary embeddings (optional
qk_norm), a gated FFN (SwiGLU / GeGLU) or the single-device MoE FFN,
parameters stacked per layer (the reference's pytree: same paths and
shapes) and the layers run as a loop, the loss chunked over the sequence.
On a mesh (``rt``) each rank runs its data rank's rows on its blocks of
the leaves: attention, the MLP, the embedding and the logits tensor-
parallel over the model axis (``layers.Split``), the MoE FFN expert-
parallel over it, and under ``FSDP_RULES`` each layer's ``embed`` blocks
gathered at the start of the layer (``common.gatherer``). The loss is the
global mean over the data ranks (``common.global_mean``); serving returns
the whole vocabulary's logits on every rank.
A ``vision_stub`` model (llava) has a 2-layer projector that maps
precomputed patch embeddings into the embedding space; they go ahead of
the text as a prefix.

Serving: ``prefill`` emits the last position's logits and a KV cache of
the whole prefix plus prompt (full attention up to ``attn_chunk``
positions, chunked past it); ``decode_step`` writes one token's K/V in
place and reads the cache through the decode-attention kernel
(``cfg.attn_decode == "fused"``), one launch per layer.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    ParamDef, Runtime, init_params, torch_dtype,
)
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (
    data_mean, gatherer, global_mean, kv_cache_defs, layer, scan_blocks,
    stack_defs, unstack,
)
from repro_torch.quant import calibrate

VISION_DIM = 1152  # the vision tower's patch embedding width


def projector_apply(pj, patches: torch.Tensor, *, dtype=None, x_scale=None,
                    site: str = "llava/projector") -> torch.Tensor:
    """2-layer MLP projector mapping vision patches into the LM embedding
    space: ``gelu(patches @ w1 + b1) @ w2`` in ``dtype`` (the patches' own
    type when None). patches: (B, P, 1152) float, or int8 codes from a
    requantizing patch embedding, dequantized here with ``x_scale`` (the
    chain's one dequant, noted for ``calibrate.counting_dequants``). The
    input is a calibration site."""
    calibrate.observe(site, patches)
    if patches.dtype == torch.int8:
        if x_scale is None:
            raise ValueError("chained int8 patches need their x_scale")
        calibrate.note_dequant(site)
        patches = patches.float() * torch.as_tensor(
            x_scale, dtype=torch.float32, device=patches.device)
    dt = dtype or patches.dtype
    v = L.act_fn("gelu")(patches.to(dt) @ pj["w1"].to(dt) + pj["b1"].to(dt))
    return v @ pj["w2"].to(dt)


class DenseLM:
    def __init__(self, cfg: ModelConfig, rt: Runtime | None = None):
        self.cfg = cfg
        self.rt = rt or Runtime()
        self.tp = L.tp_layout(cfg, self.rt)
        top = {k: v for k, v in self.param_defs().items() if k != "blocks"}
        self._gather_block = gatherer(self.block_defs(), self.rt)
        self._gather_top = gatherer(top, self.rt)

    def _whole(self, params):
        """``params`` with the leaves outside the blocks gathered where
        FSDP splits them (the blocks gather layer by layer)."""
        if self._gather_top is None:
            return params
        top = self._gather_top({k: v for k, v in params.items()
                                if k != "blocks"})
        return dict(top, blocks=params["blocks"])

    def _layer(self, lp):
        """One layer's leaves, gathered where FSDP splits them."""
        return lp if self._gather_block is None else self._gather_block(lp)

    # -- parameters ---------------------------------------------------------------
    def block_defs(self) -> dict[str, Any]:
        cfg = self.cfg
        d = {
            "attn_norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
            "attn": L.attention_defs(cfg),
            "mlp_norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        }
        if cfg.num_experts:
            d["moe"] = moe_lib.moe_defs(cfg)
        else:
            d["mlp"] = L.mlp_defs(cfg)
        return d

    def param_defs(self) -> dict[str, Any]:
        cfg = self.cfg
        defs = {
            "embed": L.embed_defs(cfg),
            "blocks": stack_defs(self.block_defs(), cfg.num_layers),
            "final_norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        }
        if cfg.frontend == "vision_stub":
            defs["projector"] = {
                "w1": ParamDef((VISION_DIM, cfg.d_model), (None, "embed"),
                               init="fan_in"),
                "b1": ParamDef((cfg.d_model,), ("embed",), init="zeros"),
                "w2": ParamDef((cfg.d_model, cfg.d_model), ("embed", "embed"),
                               init="fan_in"),
            }
        return defs

    def init(self, gen: torch.Generator):
        """Random parameters from ``gen``, on ``gen``'s device (this rank's
        blocks on a mesh)."""
        return init_params(self.param_defs(), gen, self.cfg.param_dtype,
                           self.rt)

    # -- blocks ---------------------------------------------------------------------
    def _ffn(self, lp, h):
        """The block's FFN: (output, MoE load-balancing aux or 0)."""
        if self.cfg.num_experts:
            return moe_lib.moe_apply(lp["moe"], h, self.cfg, self.rt)
        return L.mlp_apply(lp["mlp"], h, self.cfg, self.tp), 0.0

    def _attend(self, lp, h):
        """Causal self-attention over the whole sequence with rotary
        embeddings at positions 0..L-1: (projected output, k, v)."""
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        return L.self_attention(lp["attn"], h, self.cfg, causal=True,
                                positions=positions, tp=self.tp)

    def _block(self, carry, lp):
        cfg = self.cfg
        x, aux = carry
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + self._attend(lp, h)[0]
        y, a = self._ffn(lp, L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
        return x + y, aux + a

    def hidden(self, params, embeds: torch.Tensor):
        """The layers over the embeddings: (final-normed hidden states,
        aux). Each block runs under ``torch.utils.checkpoint`` when
        ``cfg.remat`` is not "none" and grad is enabled."""
        cfg = self.cfg
        aux0 = torch.zeros((), dtype=torch.float32, device=embeds.device)
        x, aux = scan_blocks((embeds, aux0), params["blocks"], self._block,
                             remat=cfg.remat != "none",
                             gather=self._gather_block)
        return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    def embeds_for(self, params, batch) -> torch.Tensor:
        """Token embeddings, with a vision stub's projected ``patches``
        ahead of them (the patch prefix, then the text)."""
        cfg = self.cfg
        e = L.embed_tokens(params["embed"], batch["tokens"], cfg, self.tp)
        if cfg.frontend == "vision_stub" and "patches" in batch:
            v = projector_apply(params["projector"], batch["patches"],
                                dtype=e.dtype)
            e = torch.cat([v, e], dim=1)
        return e

    # -- training ---------------------------------------------------------------------
    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token CE of ``batch["labels"]`` (-1 masked) plus
        ``0.01 · aux / num_layers``; patch positions carry no loss. With data
        ranks, the CE is the whole batch's mean and the aux the data ranks'
        mean."""
        cfg = self.cfg
        params = self._whole(params)
        h, aux = self.hidden(params, self.embeds_for(params, batch))
        labels = batch["labels"]
        if h.shape[1] != labels.shape[1]:  # vlm: the patch prefix
            pad = torch.full((labels.shape[0], h.shape[1] - labels.shape[1]),
                             -1, dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        ce = global_mean(*L.chunked_ce_sums(params["embed"], h, labels, cfg,
                                            self.tp), self.rt)
        return ce + 0.01 * data_mean(aux, self.rt) / max(cfg.num_layers, 1)

    # -- serving -----------------------------------------------------------------------
    def cache_defs(self, batch: int, seq: int):
        return kv_cache_defs(self.cfg, self.cfg.num_layers, batch, seq,
                             self.rt)

    def prefill(self, params, batch, *, record: list | None = None):
        """Full-sequence forward: last-position logits (B, 1, V) float32 and
        the KV cache {k, v: (layers, B, prefix + P, KV, hd)} in the param
        dtype (this rank's KV heads). ``record``, when given, receives max
        |x| of the residual stream after each layer (one host read per
        layer)."""
        cfg = self.cfg
        params = self._whole(params)
        x = self.embeds_for(params, batch)
        pd = torch_dtype(cfg.param_dtype)
        ks, vs = [], []
        for lp in unstack(params["blocks"]):
            lp = self._layer(lp)
            h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            y, k, v = self._attend(lp, h)
            ks.append(k.to(pd))
            vs.append(v.to(pd))
            x = x + y
            x = x + self._ffn(lp, L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps))[0]
            if record is not None:
                record.append(x.abs().max().item())
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = L.serve_logits(params["embed"], x[:, -1:], cfg, self.tp)
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}

    def decode_step(self, params, cache, tokens: torch.Tensor, pos: int):
        """One token for every slot at position ``pos``: logits (B, 1, V)
        float32. The cache is written in place at ``pos`` and returned."""
        cfg = self.cfg
        params = self._whole(params)
        x = L.embed_tokens(params["embed"], tokens, cfg, self.tp)
        B = x.shape[0]
        lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
        for i in range(cfg.num_layers):
            lp = self._layer(layer(params["blocks"], i))
            h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            y, _ = L.attention_decode(lp["attn"], h, layer(cache, i), pos, cfg,
                                      lengths=lengths, rope=True, tp=self.tp)
            x = x + y
            x = x + self._ffn(lp, L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps))[0]
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return L.serve_logits(params["embed"], x, cfg, self.tp), cache
