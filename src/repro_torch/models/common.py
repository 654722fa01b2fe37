"""Shared model plumbing: stacked ParamDefs, KV-cache defs and the
per-token cache write. The reference's ``scan_blocks`` becomes a plain loop
over layers in the models; serving needs no remat."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ParamDef, map_tree


def stack_defs(defs: Any, n: int) -> Any:
    """Add a leading ``layers`` dim to every ParamDef."""
    return map_tree(
        lambda d: dataclasses.replace(
            d, shape=(n, *d.shape), axes=("layers", *d.axes)
        ),
        defs,
    )


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree: views, so writes reach the stack."""
    return map_tree(lambda t: t[i], tree)


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
