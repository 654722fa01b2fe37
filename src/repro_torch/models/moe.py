"""Mixture-of-Experts FFN with expert parallelism (``repro.models.moe``).

Top-k routing with renormalised gates, a capacity-bounded dispatch of each
token's k copies into per-expert buffers, the gated expert FFN on every
buffer as one batched product, and the gate-weighted combine. The
arithmetic is the reference's: the same top-k, the same capacity
``int(max(1, T·K/E · capacity_factor))``, the same cumulative count in
token order, so the same tokens drop; tokens are dispatched in groups of
``TOKEN_GROUP`` when there are whole groups of them.

Expert parallelism (``rt`` on a mesh whose ``model`` axis divides the
experts): each rank holds its block of ``E / n_model`` experts (the
``experts`` axis of ``rt.placement``) and all of its data rank's tokens.
It routes every token, dispatches the copies that go to its own experts
(expert ids offset by its coordinate times the block), keeps the global
capacity (T the local token count), and the ranks' partial outputs are
summed over the model axis (``psum``), the aux averaged (``pmean``), as
the reference's ``shard_map`` branch does. The collectives are the
differentiable ones of ``distributed.collectives``: the tokens and the
router enter with a gradient summed over the ranks.

Where the rules also split each expert's F over a second axis (the
reference's serving 2-D rules, ``mlp=("model", "data")`` with ``batch``
whole), each rank runs its F block of its experts: the FFN's output is a
partial sum, and the combine sums over both axes, as the reference's
``psum_axes``. Under ``FSDP_RULES`` the expert leaves' ``embed`` blocks
arrive gathered (the layer's gather, ``common.gatherer``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ParamDef, Runtime, mesh_axes
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


def _ep_group(xt, router, wg, wu, wd, *, cfg: ModelConfig, n_model: int = 1,
              base: int = 0, psum_axes: tuple = (), mesh=None):
    """One token group: (T, D) -> (out (T, D), aux). ``wg``/``wu``/``wd``
    hold experts ``base .. base + E_loc`` of ``E_loc · n_model``; the
    partial output is summed and the aux averaged over ``psum_axes``."""
    T, D = xt.shape
    E_loc = wg.shape[0]
    K = cfg.experts_per_token
    E = E_loc * n_model
    gates, ids, aux = _route(xt, router, K)
    cap = int(max(1, (T * K / E) * cfg.capacity_factor))
    flat_gates = gates.reshape(T * K)
    lid = ids.reshape(T * K)
    if n_model > 1:
        # other ranks' experts count in a spare column E_loc and drop
        lid = torch.where((lid >= base) & (lid < base + E_loc), lid - base,
                          E_loc)
    onehot = F.one_hot(lid, E_loc + (n_model > 1)).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - onehot  # place BEFORE this entry
    pos_in_e = torch.gather(pos, 1, lid[:, None])[:, 0]
    keep = pos_in_e < cap
    if n_model > 1:
        keep &= lid < E_loc
    slot = torch.where(keep, lid * cap + pos_in_e,
                       torch.full_like(lid, E_loc * cap))  # E_loc*cap: dropped
    # dispatch: each token's K copies into (E_loc*cap, D), dropped ones and
    # other ranks' into a spare last row
    xt_rep = xt[:, None].expand(T, K, D).reshape(T * K, D)
    buf = torch.zeros((E_loc * cap + 1, D), dtype=xt.dtype, device=xt.device)
    buf[slot] = xt_rep
    buf = buf[:-1].reshape(E_loc, cap, D)
    out_buf = _expert_ffn(buf, wg, wu, wd, cfg.activation).reshape(E_loc * cap, D)
    # combine: the kept copies' outputs, gate-weighted, summed over K
    vals = torch.where(keep[:, None],
                       out_buf[torch.clamp(slot, max=E_loc * cap - 1)],
                       torch.zeros((), dtype=xt.dtype, device=xt.device))
    vals = vals * flat_gates[:, None].to(xt.dtype)
    out = vals.reshape(T, K, D).sum(dim=1).to(xt.dtype)
    if psum_axes:
        out = C.reduce_out(out, psum_axes, mesh)
        aux = C.mean_out(aux, psum_axes, mesh)
    return out, aux


def _ep_local(xt, router, wg, wu, wd, **kw):
    """Tokens in groups of ``TOKEN_GROUP`` (capacity enforced per group)
    when there are whole groups of them, else as one group."""
    T, D = xt.shape
    if T > TOKEN_GROUP and T % TOKEN_GROUP == 0:
        outs, aux_sum = [], torch.zeros((), device=xt.device)
        for xg in xt.split(TOKEN_GROUP):
            out, aux = _ep_group(xg, router, wg, wu, wd, **kw)
            outs.append(out)
            aux_sum = aux_sum + aux
        return torch.cat(outs), aux_sum / (T // TOKEN_GROUP)
    return _ep_group(xt, router, wg, wu, wd, **kw)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, rt: Runtime | None = None):
    """x: (B, L, D) -> (out (B, L, D), aux loss). On a mesh (``rt``) whose
    expert axis divides the experts, ``p``'s expert leaves are this rank's
    block (of its experts, and of their F where the rules split it too)
    and ``x`` this data rank's rows (all rows where ``batch`` is whole)."""
    B, L, D = x.shape
    model_ax = rt.axis_for("experts", cfg.num_experts) if rt else None
    if rt is None or rt.mesh is None or model_ax is None:
        out, aux = _ep_local(x.reshape(B * L, D), p["router"], p["wg"],
                             p["wu"], p["wd"], cfg=cfg)
        return out.reshape(B, L, D), aux
    n_model = rt.axis_size("experts")
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    wg_spec = rt.pspec(("experts", "embed_act", "mlp"), (e, d, f))
    psum_axes = tuple(dict.fromkeys(mesh_axes(wg_spec[0])
                                    + mesh_axes(wg_spec[2])))
    if p["wg"].shape[0] * n_model != e:
        raise ValueError(f"expert leaf of {p['wg'].shape[0]} experts: this "
                         f"rank's block is {e // n_model} (rt.local, "
                         f"init_params(rt=...))")
    mesh = rt.mesh
    xt = C.copy_in(x.reshape(B * L, D), psum_axes, mesh)
    router = C.copy_in(p["router"], psum_axes, mesh)
    out, aux = _ep_local(xt, router, p["wg"], p["wu"], p["wd"], cfg=cfg,
                         n_model=n_model,
                         base=rt.index(wg_spec[0]) * p["wg"].shape[0],
                         psum_axes=psum_axes, mesh=mesh)
    return out.reshape(B, L, D), aux
