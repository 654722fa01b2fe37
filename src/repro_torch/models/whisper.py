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

Parameters are the reference's pytree (same paths and shapes), as nested
dicts of tensors with a leading layer dim on the encoder and decoder
stacks.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ParamDef, init_params, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.common import (
    kv_cache_defs, layer, scan_blocks, stack_defs,
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
    """mels: (B, T, 80) -> (B, T//2, d_model)."""
    x = L.conv1d_bias_act(
        mels, p["conv1_w"], p["conv1_b"], activation="gelu", padding="SAME",
        backend=cfg.conv_backend, precision=cfg.conv_precision,
    )
    return L.conv1d_bias_act(
        x, p["conv2_w"], p["conv2_b"], activation="gelu", stride=2,
        padding="SAME", backend=cfg.conv_backend, precision=cfg.conv_precision,
    )


class Whisper:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

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
        return init_params(self.param_defs(), gen, self.cfg.param_dtype)

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
                        remat=cfg.remat != "none")
        return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _enc_block(self, x, lp):
        cfg = self.cfg
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + L.self_attention(lp["attn"], h, cfg, causal=False)[0]
        h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        return x + L.mlp_apply(lp["mlp"], h, cfg)

    # -- decoder (training) -----------------------------------------------------
    def _dec_block(self, x, lp, enc_out):
        cfg = self.cfg
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + L.attention_train(lp["attn"], h, cfg)
        h = L.rms_norm(x, lp["xattn_norm"], cfg.norm_eps)
        kv = L.encode_kv(lp["xattn"], enc_out, cfg)
        x = x + L.cross_attention(lp["xattn"], h, kv, cfg)
        h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        return x + L.mlp_apply(lp["mlp"], h, cfg)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token CE of ``batch["labels"]`` (-1 masked) given
        ``batch["frames"]`` (mels or frame embeddings) and
        ``batch["tokens"]``: a float32 scalar."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
        x = scan_blocks(x, params["decoder"],
                        functools.partial(self._dec_block, enc_out=enc_out),
                        remat=cfg.remat != "none")
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return L.chunked_ce_loss(params["embed"], x, batch["labels"], cfg)

    # -- serving ----------------------------------------------------------------
    def cache_defs(self, batch: int, seq: int):
        """Decoder self-attention cache (seq//2 rows) + cross K/V (seq//2
        encoder frames) + the per-slot encoder length."""
        cfg = self.cfg
        s_dec, s_enc = seq // 2, seq // 2
        d = kv_cache_defs(cfg, cfg.num_layers, batch, s_dec)
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        d["xk"] = ParamDef((cfg.num_layers, batch, s_enc, kv, hd), axes, init="zeros")
        d["xv"] = ParamDef((cfg.num_layers, batch, s_enc, kv, hd), axes, init="zeros")
        # per-slot real encoder length (the cross cache is zero-padded past
        # it): written once at prefill, read by every decode step
        d["enc_len"] = ParamDef((cfg.num_layers, batch), ("layers", "batch"),
                                init="zeros", dtype="int32")
        return d

    def prefill(self, params, batch):
        """Encode the frames and run the decoder over the prompt: last-token
        logits (B, 1, V) float32, and the cache {k, v, xk, xv: (layers, B,
        len, KV, hd), enc_len: (layers, B) int32}."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
        pd = torch_dtype(cfg.param_dtype)
        cache = {"k": [], "v": [], "xk": [], "xv": []}
        for i in range(cfg.num_layers):
            lp = layer(params["decoder"], i)
            h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            o, k, v = L.self_attention(lp["attn"], h, cfg, causal=True)
            x = x + o
            h = L.rms_norm(x, lp["xattn_norm"], cfg.norm_eps)
            xk, xv = L.encode_kv(lp["xattn"], enc_out, cfg)
            x = x + L.cross_attention(lp["xattn"], h, (xk, xv), cfg)
            h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + L.mlp_apply(lp["mlp"], h, cfg)
            for name, t in (("k", k), ("v", v), ("xk", xk), ("xv", xv)):
                cache[name].append(t.to(pd))
        cache = {n: torch.stack(ts) for n, ts in cache.items()}
        cache["enc_len"] = torch.full(
            (cfg.num_layers, x.shape[0]), enc_out.shape[1], dtype=torch.int32,
            device=x.device,
        )
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return L.lm_logits(params["embed"], x[:, -1:], cfg), cache

    def decode_step(self, params, cache, tokens: torch.Tensor, pos: int):
        """One token for every slot at position ``pos``: logits (B, 1, V)
        float32. The cache is updated in place and returned."""
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], tokens, cfg)
        B = x.shape[0]
        pe = L.sinusoidal_positions(cache["k"].shape[2], cfg.d_model, x.device)
        x = x + pe[pos][None, None].to(x.dtype)
        lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
        for i in range(cfg.num_layers):
            lp = layer(params["decoder"], i)
            cl = layer(cache, i)
            h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            y, _ = L.attention_decode(lp["attn"], h, {"k": cl["k"], "v": cl["v"]},
                                      pos, cfg, lengths=lengths)
            x = x + y
            h = L.rms_norm(x, lp["xattn_norm"], cfg.norm_eps)
            x = x + L.cross_attention_decode(lp["xattn"], h, cl, cfg)
            h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + L.mlp_apply(lp["mlp"], h, cfg)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return L.lm_logits(params["embed"], x, cfg), cache
