"""Parameter definitions and seeded initialisation.

The subset of ``repro.distributed.sharding`` that a single-device port
needs: ``ParamDef`` (shape, logical axes, init rule) and ``init_params``,
which fills a nested dict of ParamDefs with tensors drawn from one
``torch.Generator``. Mesh rules have no counterpart yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    "int8": torch.int8,
}


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[name]


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis per dim
    init: str = "normal"  # normal | zeros | ones | small | fan_in
    dtype: str | None = None  # override model param dtype
    scale: float | None = None  # stddev override for normal init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def iter_leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict in sorted-key order, the order
    ``jax.tree.flatten`` visits a dict pytree. Paths join keys with '/'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


# float32 elements of one init draw (2.1 GB). A larger leaf is drawn in
# slices: a whole float32 draw of qwen3-moe's 9.7 G-element expert leaf
# would take 38.7 GB beside the leaves already drawn.
MAX_DRAW = 2 ** 29


def _init_leaf(gen: torch.Generator, d: ParamDef, default_dtype) -> torch.Tensor:
    """One leaf, following the reference's ``_init_leaf`` rule for rule.

    The reference takes ``fan_in = shape[0]`` of the leaf as stored, so for
    a per-layer weight stacked to (layers, ...) the fan-in is the layer
    count, not the input width. That behaviour is kept on purpose: the
    port must draw from the same distribution as the reference.

    A leaf of at most ``MAX_DRAW`` elements is one ``torch.randn`` call. A
    larger one is allocated once in its dtype and filled one index of its
    leading axis at a time (recursing while a slice is still larger), each
    slice scaled with the whole leaf's scale."""
    dtype = torch_dtype(d.dtype or default_dtype)
    dev = gen.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=dev)
    fan_in = d.shape[0] if len(d.shape) >= 1 else 1
    if d.scale is not None:
        scale = d.scale
    elif d.init == "normal":
        scale = 0.02
    elif d.init == "small":
        scale = 0.01
    else:  # fan_in
        scale = 1.0 / max(fan_in, 1) ** 0.5
    if math.prod(d.shape) <= MAX_DRAW:
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=dev)
        # scaled in place: one float32 copy of the leaf at a time
        return x.mul_(scale).to(dtype)
    out = torch.empty(d.shape, dtype=dtype, device=dev)
    _fill_bounded(out, gen, scale)
    return out


def _fill_bounded(out: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    """Fill ``out`` with N(0, scale^2) draws of at most ``MAX_DRAW``
    float32 elements each, in index order of its leading axes."""
    if out.numel() <= max(MAX_DRAW, 1):
        x = torch.randn(out.shape, generator=gen, dtype=torch.float32,
                        device=out.device)
        out.copy_(x.mul_(scale))
        return
    for i in range(out.shape[0]):
        _fill_bounded(out[i], gen, scale)


def init_params(defs: Any, gen: torch.Generator, default_dtype) -> Any:
    """Concrete seeded init of a ParamDef tree, on ``gen``'s device. Leaves
    draw in sorted-path order from the one generator, each in draws of at
    most ``MAX_DRAW`` float32 elements (``_init_leaf``)."""
    out: dict = {}
    for path, d in iter_leaves(defs):
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = _init_leaf(gen, d, default_dtype)
    return out
