"""Shared model plumbing: stacked ParamDefs, the loop over layers, KV-cache
defs and the per-token cache write."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ParamDef, iter_leaves, map_tree


def stack_defs(defs: Any, n: int) -> Any:
    """Add a leading ``layers`` dim to every ParamDef."""
    return map_tree(
        lambda d: dataclasses.replace(
            d, shape=(n, *d.shape), axes=("layers", *d.axes)
        ),
        defs,
    )


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree: views, so writes reach the stack (the
    serving cache)."""
    return map_tree(lambda t: t[i], tree)


def unstack(tree: dict) -> list[dict]:
    """The layers of a stacked tree, one ``torch.unbind`` per leaf. Its
    backward is one ``stack`` per leaf; indexing each layer instead would
    write a zero tensor the size of the whole stack per layer."""
    leaves = map_tree(torch.unbind, tree)
    n = len(next(iter(iter_leaves(leaves)))[1])
    return [map_tree(lambda ts: ts[i], leaves) for i in range(n)]


def scan_blocks(x: Any, stacked: dict, body: Callable[[Any, dict], Any], *,
                remat: bool = True) -> Any:
    """Run ``body(carry, layer_params)`` over the layers of ``stacked``
    (the reference's ``scan_blocks``, as a loop). With ``remat`` and grad
    enabled, each block runs under ``torch.utils.checkpoint``: its
    activations are recomputed in backward instead of kept."""
    ckpt = remat and torch.is_grad_enabled()
    for lp in unstack(stacked):
        x = checkpoint(body, x, lp, use_reentrant=False) if ckpt else body(x, lp)
    return x


def kv_cache_defs(cfg: ModelConfig, layers: int, batch: int, seq: int):
    if cfg.kv_quant != "fp":
        raise NotImplementedError(f"kv_quant {cfg.kv_quant!r} is not ported yet")
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return dict(
        k=ParamDef((layers, batch, seq, kv, hd), axes, init="zeros"),
        v=ParamDef((layers, batch, seq, kv, hd), axes, init="zeros"),
    )


def store_kv_token(cache: dict, name: str, fresh: torch.Tensor, pos: int, *,
                   axis: int = 1) -> None:
    """Write one new token's rows of cache leaf ``name`` at ``pos`` along
    ``axis`` (the kv_seq axis of a per-layer decode leaf). Unlike the
    reference, which returns new arrays, this updates the cache tensor **in
    place**."""
    leaf = cache[name]
    leaf.narrow(axis, pos, fresh.shape[axis]).copy_(fresh.to(leaf.dtype))
