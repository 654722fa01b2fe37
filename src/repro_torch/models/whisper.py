"""Whisper (arXiv:2212.04356): encoder-decoder with a conv frontend.

The frontend (conv1d K=3 + gelu over 80-dim mels, then conv1d K=3 stride 2
+ gelu) is the paper-technique site: with ``conv_backend="sliding_pallas"``
each conv is one launch of the sliding conv1d CUDA kernel, bias and gelu
fused. Encoder: bidirectional self-attention + plain-GELU MLP, sinusoidal
positions. Decoder: causal self-attention + cross-attention + MLP. Serving
runs ``prefill`` once, then ``decode_step`` per token, whose self- and
cross-attention reads go through the decode-attention CUDA kernel.
Training takes ``loss``: the encoder and decoder stacks run block by block
through ``scan_blocks`` (recomputed in backward unless ``cfg.remat`` is
"none"), and the convs differentiate through the kernels' backward.

int8 serving: with ``cfg.conv_precision`` "w8a8" and the frontend weights
swapped for ``QuantizedWeight`` leaves (``repro_torch.quant.apply``) each
conv is one launch of the int8 sliding conv kernel; conv1's leaf carries
conv2's input scale as ``out_scale``, so conv1 requantizes in its epilogue
and hands conv2 int8 codes (no float tensor between the two). With
``cfg.kv_quant == "int8"`` every cache leaf proportional to the sequence
(self-attention k/v, cross xk/xv) stores int8 codes with per-row scales.

Parameters are the reference's pytree (same paths and shapes), as nested
dicts of tensors with a leading layer dim on the encoder and decoder
stacks. On a mesh (``rt``) each rank runs its data rank's rows on its
blocks of the leaves: self- and cross-attention and the MLP tensor-
parallel over the model axis (``layers.Split``; the cross cache ``xk`` /
``xv`` on the rank's KV heads), the vocabulary too where the model axis
divides it (the published 51,865 rows stay whole). Under ``FSDP_RULES``
each layer's ``embed`` blocks are gathered at the start of the layer and
the frontend's and the other top leaves' before use (``common.gatherer``),
so the convs launch on whole weights. The loss is the whole batch's mean.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    ParamDef, Runtime, init_params, torch_dtype,
)
from repro_torch.models import layers as L
from repro_torch.models.common import (
    gatherer, global_mean, kv_cache_defs, kv_scale_defs, layer,
    local_kv_heads, scan_blocks, stack_defs,
)

N_MELS = 80


def frontend_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d = cfg.d_model
    return {
        "conv1_w": ParamDef((3, N_MELS, d), (None, None, "embed"), init="fan_in"),
        "conv1_b": ParamDef((d,), ("embed",), init="zeros"),
        "conv2_w": ParamDef((3, d, d), (None, "embed", "embed"), init="fan_in"),
        "conv2_b": ParamDef((d,), ("embed",), init="zeros"),
    }


def conv_frontend(p, mels: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """mels: (B, T, 80) -> (B, T//2, d_model). The site names key the
    calibration spec."""
    x = L.conv1d_bias_act(
        mels, p["conv1_w"], p["conv1_b"], activation="gelu", padding="SAME",
        backend=cfg.conv_backend, precision=cfg.conv_precision,
        site="whisper/conv1",
    )
    return L.conv1d_bias_act(
        x, p["conv2_w"], p["conv2_b"], activation="gelu", stride=2,
        padding="SAME", backend=cfg.conv_backend, precision=cfg.conv_precision,
        site="whisper/conv2",
    )


class Whisper:
    def __init__(self, cfg: ModelConfig, rt: Runtime | None = None):
        self.cfg = cfg
        self.rt = rt or Runtime()
        self.tp = L.tp_layout(cfg, self.rt)
        defs = self.param_defs()
        self._gather_enc = gatherer(self._enc_block_defs(), self.rt)
        self._gather_dec = gatherer(self._dec_block_defs(), self.rt)
        self._gather_top = gatherer(
            {k: v for k, v in defs.items() if k not in ("encoder", "decoder")},
            self.rt)

    def _whole(self, params):
        """``params`` with the leaves outside the stacks gathered where FSDP
        splits them (the stacks gather layer by layer)."""
        if self._gather_top is None:
            return params
        top = self._gather_top({k: v for k, v in params.items()
                                if k not in ("encoder", "decoder")})
        return dict(top, encoder=params["encoder"], decoder=params["decoder"])

    def _dec_layer(self, params, i: int):
        lp = layer(params["decoder"], i)
        return lp if self._gather_dec is None else self._gather_dec(lp)

    # -- parameters -----------------------------------------------------------
    def _enc_block_defs(self):
        cfg = self.cfg
        return {
            "attn_norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
            "attn": L.attention_defs(cfg),
            "mlp_norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
            "mlp": L.mlp_defs(cfg),
        }

    def _dec_block_defs(self):
        cfg = self.cfg
        return {
            "attn_norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
            "attn": L.attention_defs(cfg),
            "xattn_norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
            "xattn": L.cross_attention_defs(cfg),
            "mlp_norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
            "mlp": L.mlp_defs(cfg),
        }

    def param_defs(self):
        cfg = self.cfg
        return {
            "embed": L.embed_defs(cfg),
            "frontend": frontend_defs(cfg),
            "encoder": stack_defs(self._enc_block_defs(), cfg.encoder_layers),
            "enc_norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
            "decoder": stack_defs(self._dec_block_defs(), cfg.num_layers),
            "final_norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        }

    def init(self, gen: torch.Generator):
        """Random parameters from ``gen``, on ``gen``'s device."""
        return init_params(self.param_defs(), gen, self.cfg.param_dtype,
                           self.rt)

    # -- encoder --------------------------------------------------------------
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: mels (B, T, 80) through the conv frontend, or frame
        embeddings (B, S_enc, d)."""
        cfg = self.cfg
        if frames.shape[-1] == N_MELS:
            frames = conv_frontend(params["frontend"], frames, cfg)
        x = frames.to(L.cdtype(cfg))
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
        x = scan_blocks(x, params["encoder"], self._enc_block,
                        remat=cfg.remat != "none", gather=self._gather_enc)
        return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _enc_block(self, x, lp):
        cfg, tp = self.cfg, self.tp
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + L.self_attention(lp["attn"], h, cfg, causal=False, tp=tp)[0]
        h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        return x + L.mlp_apply(lp["mlp"], h, cfg, tp)

    # -- decoder (training) -----------------------------------------------------
    def _dec_block(self, x, lp, enc_out):
        cfg, tp = self.cfg, self.tp
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + L.attention_train(lp["attn"], h, cfg, tp=tp)
        h = L.rms_norm(x, lp["xattn_norm"], cfg.norm_eps)
        kv = L.encode_kv(lp["xattn"], enc_out, cfg, tp)
        x = x + L.cross_attention(lp["xattn"], h, kv, cfg, tp)
        h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        return x + L.mlp_apply(lp["mlp"], h, cfg, tp)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token CE of ``batch["labels"]`` (-1 masked) given
        ``batch["frames"]`` (mels or frame embeddings) and
        ``batch["tokens"]``: a float32 scalar, over the whole batch with
        data ranks (``common.global_mean``)."""
        cfg = self.cfg
        params = self._whole(params)
        enc_out = self.encode(params, batch["frames"])
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg, self.tp)
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
        x = scan_blocks(x, params["decoder"],
                        functools.partial(self._dec_block, enc_out=enc_out),
                        remat=cfg.remat != "none", gather=self._gather_dec)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return global_mean(*L.chunked_ce_sums(params["embed"], x,
                                              batch["labels"], cfg, self.tp),
                           self.rt)

    # -- serving ----------------------------------------------------------------
    def cache_defs(self, batch: int, seq: int):
        """Decoder self-attention cache (seq//2 rows) + cross K/V (seq//2
        encoder frames) + the per-slot encoder length. With ``cfg.kv_quant
        == "int8"`` the self and cross K/V store int8 codes, each with its
        per-row ``_scale`` sibling. On a mesh, this rank's KV heads."""
        cfg = self.cfg
        s_dec, s_enc = seq // 2, seq // 2
        d = kv_cache_defs(cfg, cfg.num_layers, batch, s_dec, self.rt)
        kv, hd = local_kv_heads(cfg, self.rt), cfg.resolved_head_dim
        axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        dt = "int8" if cfg.kv_quant == "int8" else None
        for name in ("xk", "xv"):
            d[name] = ParamDef((cfg.num_layers, batch, s_enc, kv, hd), axes,
                               init="zeros", dtype=dt)
        # per-slot real encoder length (the cross cache is zero-padded past
        # it): written once at prefill, read by every decode step
        d["enc_len"] = ParamDef((cfg.num_layers, batch), ("layers", "batch"),
                                init="zeros", dtype="int32")
        if dt:
            d.update(kv_scale_defs({"xk": d["xk"], "xv": d["xv"]}))
        return d

    def prefill(self, params, batch):
        """Encode the frames and run the decoder over the prompt: last-token
        logits (B, 1, V) float32, and the cache {k, v, xk, xv: (layers, B,
        len, KV, hd), enc_len: (layers, B) int32}."""
        cfg, tp = self.cfg, self.tp
        params = self._whole(params)
        enc_out = self.encode(params, batch["frames"])
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg, tp)
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
        pd = torch_dtype(cfg.param_dtype)
        cache = {"k": [], "v": [], "xk": [], "xv": []}
        for i in range(cfg.num_layers):
            lp = self._dec_layer(params, i)
            h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            o, k, v = L.self_attention(lp["attn"], h, cfg, causal=True, tp=tp)
            x = x + o
            h = L.rms_norm(x, lp["xattn_norm"], cfg.norm_eps)
            xk, xv = L.encode_kv(lp["xattn"], enc_out, cfg, tp)
            x = x + L.cross_attention(lp["xattn"], h, (xk, xv), cfg, tp)
            h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + L.mlp_apply(lp["mlp"], h, cfg, tp)
            for name, t in (("k", k), ("v", v), ("xk", xk), ("xv", xv)):
                cache[name].append(t.to(pd))
        cache = {n: torch.stack(ts) for n, ts in cache.items()}
        cache["enc_len"] = torch.full(
            (cfg.num_layers, x.shape[0]), enc_out.shape[1], dtype=torch.int32,
            device=x.device,
        )
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return L.serve_logits(params["embed"], x[:, -1:], cfg, tp), cache

    def decode_step(self, params, cache, tokens: torch.Tensor, pos: int):
        """One token for every slot at position ``pos``: logits (B, 1, V)
        float32. The cache (with its ``_scale`` leaves when int8) is updated
        in place and returned."""
        cfg, tp = self.cfg, self.tp
        params = self._whole(params)
        x = L.embed_tokens(params["embed"], tokens, cfg, tp)
        B = x.shape[0]
        pe = L.sinusoidal_positions(cache["k"].shape[2], cfg.d_model, x.device)
        x = x + pe[pos][None, None].to(x.dtype)
        lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
        for i in range(cfg.num_layers):
            lp = self._dec_layer(params, i)
            cl = layer(cache, i)
            h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            sub = {n: cl[n] for n in ("k", "v", "k_scale", "v_scale")
                   if n in cl}
            y, _ = L.attention_decode(lp["attn"], h, sub, pos, cfg,
                                      lengths=lengths, tp=tp)
            x = x + y
            h = L.rms_norm(x, lp["xattn_norm"], cfg.norm_eps)
            x = x + L.cross_attention_decode(lp["xattn"], h, cl, cfg, tp)
            h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + L.mlp_apply(lp["mlp"], h, cfg, tp)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return L.serve_logits(params["embed"], x, cfg, tp), cache
