"""Shared model plumbing: stacked ParamDefs, the loop over layers, FSDP's
gather of a layer's weights, KV-cache defs (float, or int8 with per-row
scales; this rank's KV heads on a mesh), the per-token cache write and the
``attn_`` prefix views of a hybrid model's cache."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (
    ParamDef, Runtime, iter_leaves, map_tree, mesh_axes,
)
from repro_torch.optim.compress import quantize_int8
from repro_torch.quant.qconv import QuantizedWeight


def global_mean(tot: torch.Tensor, cnt: torch.Tensor,
                rt: Runtime | None) -> torch.Tensor:
    """``tot / cnt`` over the whole batch. With data ranks (``rt.dp_size >
    1``) the sum and the count are all-reduced over ``rt.dp_axes()``: the
    mean of the shards' means would weigh a shard of fewer labels as much
    as one of more. The value is the global mean on every rank; its
    gradient is this rank's share times the data group's size, so the
    ranks' gradients averaged (``launch.steps``) are the global mean's."""
    n = rt.dp_size if rt is not None else 1
    if n == 1:
        return tot / torch.clamp(cnt, min=1.0)
    axes, mesh = rt.dp_axes(), rt.mesh
    tot_all = C.psum(tot.detach(), axes, mesh)
    cnt_all = C.psum(cnt.detach(), axes, mesh)
    return (tot_all + n * (tot - tot.detach())) / torch.clamp(cnt_all, min=1.0)


def data_mean(x: torch.Tensor, rt: Runtime | None) -> torch.Tensor:
    """``x`` averaged over the data ranks (the MoE aux under data
    parallelism), its gradient this rank's own: averaged with the others'
    (``launch.steps``), the mean's."""
    n = rt.dp_size if rt is not None else 1
    if n == 1:
        return x
    return x + (C.pmean(x.detach(), rt.dp_axes(), rt.mesh) - x.detach())


def stack_defs(defs: Any, n: int) -> Any:
    """Add a leading ``layers`` dim to every ParamDef."""
    return map_tree(
        lambda d: dataclasses.replace(
            d, shape=(n, *d.shape), axes=("layers", *d.axes)
        ),
        defs,
    )


def _index(t, i: int):
    """Entry ``i`` along the leading (layers) axis of a leaf; a stacked
    ``QuantizedWeight`` gives each of its tensors' entry ``i``."""
    if isinstance(t, QuantizedWeight):
        return QuantizedWeight(*(None if f is None else f[i] for f in t))
    return t[i]


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree: views, so writes reach the stack (the
    serving cache)."""
    return map_tree(lambda t: _index(t, i), tree)


def unstack(tree: dict) -> list[dict]:
    """The layers of a stacked tree, one ``torch.unbind`` per leaf. Its
    backward is one ``stack`` per leaf; indexing each layer instead would
    write a zero tensor the size of the whole stack per layer."""
    leaves = map_tree(torch.unbind, tree)
    n = len(next(iter(iter_leaves(leaves)))[1])
    return [map_tree(lambda ts: ts[i], leaves) for i in range(n)]


def gatherer(defs: Any, rt: Runtime | None) -> Callable[[Any], Any] | None:
    """FSDP's gather for a tree of leaves of ``defs`` (one layer's): a
    function giving the tree with every ``embed`` dim that ``rt`` splits
    all-gathered over its axes (``collectives.gather_in``: reduce-scattered
    in backward), leaf by leaf in sorted-path order, the same on every
    rank; None when ``rt`` splits no ``embed`` dim of them."""
    if rt is None or rt.mesh is None:
        return None
    plan = []
    for path, d in iter_leaves(defs):
        for dim, (ax, entry) in enumerate(zip(d.axes, rt.placement(d))):
            axes = tuple(a for a in mesh_axes(entry) if rt.mesh.shape[a] > 1)
            if ax == "embed" and axes:
                plan.append((path, dim, axes))
    if not plan:
        return None
    mesh = rt.mesh

    def gather(tree: Any) -> Any:
        leaves = dict(iter_leaves(tree))
        for path, dim, axes in plan:
            leaves[path] = C.gather_in(leaves[path], axes, mesh, dim)
        out: dict = {}
        for path, t in leaves.items():
            node = out
            *parents, name = path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = t
        return out

    return gather


def scan_blocks(x: Any, stacked: dict, body: Callable[[Any, dict], Any], *,
                remat: bool = True, collect: bool = False,
                gather: Callable[[Any], Any] | None = None) -> Any:
    """Run ``body(carry, layer_params)`` over the layers of ``stacked``
    (the reference's ``scan_blocks``, as a loop). With ``remat`` and grad
    enabled, each block runs under ``torch.utils.checkpoint``: its
    activations are recomputed in backward instead of kept. ``gather``
    (``gatherer``) runs first inside the block, so under FSDP one layer's
    whole weights exist at a time and the recompute gathers them again.

    ``collect=True``: ``body`` returns ``(carry, aux)``, aux a dict tree of
    tensors, and the result is ``(carry, aux stacked along a new leading
    layers axis)`` (a prefill's per-layer states)."""
    ckpt = remat and torch.is_grad_enabled()
    if gather is not None:
        inner = body

        def body(x, lp):
            return inner(x, gather(lp))
    auxes = []
    for lp in unstack(stacked):
        x = checkpoint(body, x, lp, use_reentrant=False) if ckpt else body(x, lp)
        if collect:
            x, aux = x
            auxes.append(aux)
    return (x, _stack(auxes)) if collect else x


def _stack(trees: list) -> Any:
    """One tree of the leaves of ``trees`` stacked along a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def local_kv_heads(cfg: ModelConfig, rt: Runtime | None) -> int:
    """The KV heads a rank's cache holds: its block of ``wk``'s kv heads,
    all of them where the rules split ``head_dim`` instead (k and v are
    gathered whole before they are cached)."""
    from repro_torch.models.layers import attention_defs

    if rt is None or rt.mesh is None:
        return cfg.num_kv_heads
    return rt.block_shape(attention_defs(cfg)["wk"])[1]


def kv_cache_defs(cfg: ModelConfig, layers: int, batch: int, seq: int,
                  rt: Runtime | None = None):
    """Self-attention K/V cache defs, on this rank's KV heads
    (``local_kv_heads``) and its ``batch`` rows. With ``cfg.kv_quant ==
    "int8"`` the leaves store int8 codes, each with its ``<name>_scale``
    sibling."""
    if cfg.kv_quant not in ("fp", "int8"):
        raise ValueError(f"unknown kv_quant {cfg.kv_quant!r}")
    kv, hd = local_kv_heads(cfg, rt), cfg.resolved_head_dim
    axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    dt = "int8" if cfg.kv_quant == "int8" else None  # None: param dtype
    d = dict(
        k=ParamDef((layers, batch, seq, kv, hd), axes, init="zeros", dtype=dt),
        v=ParamDef((layers, batch, seq, kv, hd), axes, init="zeros", dtype=dt),
    )
    if dt:
        d.update(kv_scale_defs(d))
    return d


def kv_scale_defs(defs: dict) -> dict:
    """float32 per-row scale leaves pairing int8 cache leaves: ``name``
    gets ``<name>_scale`` of its shape with the row (last) axis 1, keeping
    the ``kv_seq`` axis name so the prefill padding pads the pair alike."""
    return {
        f"{name}_scale": ParamDef((*d.shape[:-1], 1), (*d.axes[:-1], None),
                                  init="zeros", dtype="float32")
        for name, d in defs.items()
    }


def quantize_kv_leaf(value: torch.Tensor):
    """THE int8 KV quantizer: absmax over the last (head_dim) axis per
    (..., position, head) row, through ``optim.compress.quantize_int8``.
    The prefill cache (``serve.quantize_cache_to_defs``) and the per-token
    write (:func:`store_kv_token`) both go through it, so the two halves of
    the (codes, scale) pair share one grid. Returns (int8 codes, float32
    scales with the last axis 1)."""
    return quantize_int8(value)


def store_kv_token(cache: dict, name: str, fresh: torch.Tensor, pos: int, *,
                   axis: int = 1) -> None:
    """Write one new token's rows of cache leaf ``name`` at ``pos`` along
    ``axis`` (the kv_seq axis of a per-layer decode leaf). When the cache
    stores int8 (a ``<name>_scale`` sibling exists), the fresh rows
    quantize through :func:`quantize_kv_leaf` and both leaves of the pair
    are written. Unlike the reference, which returns new arrays, this
    updates the cache tensors **in place**."""
    leaf = cache[name]
    n = fresh.shape[axis]
    scale = cache.get(f"{name}_scale")
    if scale is not None:
        q, s = quantize_kv_leaf(fresh)
        leaf.narrow(axis, pos, n).copy_(q)
        scale.narrow(axis, pos, n).copy_(s)
        return
    leaf.narrow(axis, pos, n).copy_(fresh.to(leaf.dtype))


def strip_kv_prefix(cache: dict, prefix: str) -> dict:
    """The ``prefix``-named K/V leaves under their bare names (``attn_k`` →
    ``k``), their ``_scale`` siblings with them, so a model hands
    ``attention_decode`` the whole (codes, scale) set without naming the
    scale leaves. The tensors are the cache's own: writes reach it."""
    return {name[len(prefix):]: leaf for name, leaf in cache.items()
            if name.startswith(prefix)}


def add_kv_prefix(leaves: dict, prefix: str) -> dict:
    """Inverse of :func:`strip_kv_prefix`."""
    return {f"{prefix}{name}": leaf for name, leaf in leaves.items()}
