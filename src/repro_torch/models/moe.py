"""Mixture-of-Experts FFN, on one device (``repro.models.moe`` without a
mesh).

Top-k routing with renormalised gates, a capacity-bounded dispatch of each
token's k copies into per-expert buffers, the gated expert FFN on every
buffer as one batched product, and the gate-weighted combine. The
arithmetic is the reference's no-mesh path: the same top-k, the same
capacity ``int(max(1, T·K/E · capacity_factor))``, the same cumulative
count in token order, so the same tokens drop; tokens are dispatched in
groups of ``TOKEN_GROUP`` when there are whole groups of them.

Not ported yet: the expert-parallel path over a mesh (the reference's
``shard_map`` branch with its psum over the model axis).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ParamDef
from repro_torch.models.layers import act_fn

TOKEN_GROUP = 8192  # tokens dispatched per group (capacity per group)


def moe_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamDef((d, e), ("embed", None), init="normal", dtype="float32"),
        "wg": ParamDef((e, d, f), ("experts", "embed", "mlp"), init="fan_in"),
        "wu": ParamDef((e, d, f), ("experts", "embed", "mlp"), init="fan_in"),
        "wd": ParamDef((e, f, d), ("experts", "mlp", "embed"), init="fan_in"),
    }


def _route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """Top-k routing with renormalised gates. xt: (T, D). Returns gates
    (T, k) float32, expert ids (T, k) and the load-balancing auxiliary."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style auxiliary: mean router probability times mean load
    n_exp = router.shape[1]
    load = F.one_hot(ids[:, 0], n_exp).float().mean(dim=0)
    aux = n_exp * (load * probs.mean(dim=0)).sum()
    return gates, ids, aux


def _expert_ffn(buf: torch.Tensor, wg, wu, wd, activation: str) -> torch.Tensor:
    """buf: (E, C, D) -> (E, C, D), each expert's gated FFN."""
    dt = buf.dtype
    g = torch.bmm(buf, wg.to(dt))
    u = torch.bmm(buf, wu.to(dt))
    return torch.bmm(act_fn(activation)(g) * u, wd.to(dt))


def _ep_group(xt, router, wg, wu, wd, *, cfg: ModelConfig):
    """One token group: (T, D) -> (out (T, D), aux)."""
    T, D = xt.shape
    E = wg.shape[0]
    K = cfg.experts_per_token
    gates, ids, aux = _route(xt, router, K)
    cap = int(max(1, (T * K / E) * cfg.capacity_factor))
    flat_ids = ids.reshape(T * K)
    flat_gates = gates.reshape(T * K)
    onehot = F.one_hot(flat_ids, E).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - onehot  # place BEFORE this entry
    pos_in_e = torch.gather(pos, 1, flat_ids[:, None])[:, 0]
    keep = pos_in_e < cap
    slot = torch.where(keep, flat_ids * cap + pos_in_e,
                       torch.full_like(flat_ids, E * cap))  # E*cap: dropped
    # dispatch: each token's K copies into (E*cap, D), dropped ones into a
    # spare last row
    xt_rep = xt[:, None].expand(T, K, D).reshape(T * K, D)
    buf = torch.zeros((E * cap + 1, D), dtype=xt.dtype, device=xt.device)
    buf[slot] = xt_rep
    buf = buf[:-1].reshape(E, cap, D)
    out_buf = _expert_ffn(buf, wg, wu, wd, cfg.activation).reshape(E * cap, D)
    # combine: the kept copies' outputs, gate-weighted, summed over K
    vals = torch.where(keep[:, None], out_buf[torch.clamp(slot, max=E * cap - 1)],
                       torch.zeros((), dtype=xt.dtype, device=xt.device))
    vals = vals * flat_gates[:, None].to(xt.dtype)
    return vals.reshape(T, K, D).sum(dim=1).to(xt.dtype), aux


def _ep_local(xt, router, wg, wu, wd, *, cfg: ModelConfig):
    """Tokens in groups of ``TOKEN_GROUP`` (capacity enforced per group)
    when there are whole groups of them, else as one group."""
    T, D = xt.shape
    if T > TOKEN_GROUP and T % TOKEN_GROUP == 0:
        outs, aux_sum = [], torch.zeros((), device=xt.device)
        for xg in xt.split(TOKEN_GROUP):
            out, aux = _ep_group(xg, router, wg, wu, wd, cfg=cfg)
            outs.append(out)
            aux_sum = aux_sum + aux
        return torch.cat(outs), aux_sum / (T // TOKEN_GROUP)
    return _ep_group(xt, router, wg, wu, wd, cfg=cfg)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, L, D) -> (out (B, L, D), aux loss)."""
    B, L, D = x.shape
    out, aux = _ep_local(x.reshape(B * L, D), p["router"], p["wg"], p["wu"],
                         p["wd"], cfg=cfg)
    return out.reshape(B, L, D), aux
