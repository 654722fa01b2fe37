"""Carry weights across from the JAX reference.

``params_from_numpy`` turns the reference's parameter pytree, handed over
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on
the JAX side), into this package's nested dict of tensors with the same
paths. JAX's random generator cannot be reproduced in torch, so parity
tests build the weights once in the reference and move them here. A
quantized tree carries across too: the reference's ``QuantizedWeight``
leaves (``jax.tree.map(np.asarray, ...)`` keeps them as named tuples of
numpy arrays, ``None`` where a scale is absent) become this package's
``quant.QuantizedWeight``, their types and shapes checked, among them
jamba's period-stacked depthwise ``conv_w`` leaves.

``state_from_step_dir`` loads a ``CheckpointManager`` step directory,
written by either package, onto the port's parameter and optimizer trees,
int8 moments included.

``params_block_from_numpy`` is the carry for one rank of a mesh: this
rank's block of each leaf by ``rt.placement``, so the reference's weights
run on the port's mesh.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.manager import from_numpy
from repro_torch.distributed.sharding import ParamDef, Runtime, iter_leaves
from repro_torch.quant.qconv import QuantizedWeight


def _to_tensor(a: Any, device, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: torch has no numpy bf16
        t = torch.from_numpy(a.view(np.uint16).astype(np.int32) << 16)
        t = t.view(torch.float32).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))  # owned and writable
    return t.to(device=device, dtype=dtype or t.dtype)


def _is_quantized(a: Any) -> bool:
    """A quantized leaf of either package: a named tuple with the fields of
    ``QuantizedWeight``."""
    return getattr(a, "_fields", None) == QuantizedWeight._fields


def _quantized_leaf(a: Any, device) -> QuantizedWeight:
    """The reference's quantized leaf as this package's, its types and
    shapes checked: int8 codes; a float32 scale, (Cout,) for a conv weight
    or (…, 1, C) for a depthwise (…, K, C) weight (per channel over the tap
    axis, periods stacked ahead); activation scales float32, one per leaf
    (one per stacked layer for a depthwise leaf)."""
    q = _to_tensor(a.q, device, None)
    scale = _to_tensor(a.scale, device, None)
    if q.dtype != torch.int8:
        raise ValueError(f"quantized leaf codes are {q.dtype}, not int8")
    depthwise = scale.shape == (*q.shape[:-2], 1, q.shape[-1])
    if scale.dtype != torch.float32 or not (
            depthwise or scale.shape == q.shape[-1:]):
        raise ValueError(f"quantized leaf scale {scale.dtype} "
                         f"{tuple(scale.shape)} is not float32 "
                         f"({q.shape[-1]},) or (..., 1, {q.shape[-1]})")
    act_shape = q.shape[:-2] if depthwise else torch.Size()
    extra = []
    for name in ("x_scale", "out_scale"):
        t = getattr(a, name)
        if t is not None:
            t = _to_tensor(t, device, None)
            if t.dtype != torch.float32 or t.numel() != act_shape.numel():
                raise ValueError(f"quantized leaf {name} {t.dtype} "
                                 f"{tuple(t.shape)} is not float32 "
                                 f"{tuple(act_shape)}")
            t = t.reshape(act_shape)
        extra.append(t)
    return QuantizedWeight(q, scale, *extra)


def _leaf_shape(a: Any) -> tuple:
    if _is_quantized(a) or isinstance(a, tuple):  # quantized weight, moment
        a = a[0]
    return tuple(np.shape(a))


def _check_defs(tree: Any, defs: Any) -> None:
    """Raise unless ``tree`` has the paths of ``defs`` and every leaf's
    shape (a quantized leaf's or an int8 moment's codes) is its def's."""
    want = {p: d.shape for p, d in iter_leaves(defs)
            if isinstance(d, ParamDef)}
    got = {p: _leaf_shape(a) for p, a in iter_leaves(tree)}
    if want != got:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(p for p in set(want) & set(got) if want[p] != got[p])
        raise ValueError(
            f"param tree does not match the model's defs: missing "
            f"{missing}, unexpected {extra}, shape mismatch "
            f"{[(p, got[p], want[p]) for p in wrong]}"
        )


def params_from_numpy(tree: Any, device, dtype: torch.dtype | None = None,
                      defs: Any = None) -> Any:
    """Nested dict of numpy arrays → nested dict of tensors on ``device``
    (cast to ``dtype`` when given; quantized leaves keep their types). With
    ``defs`` (the model's ``param_defs()``), the paths and every leaf's
    shape (a quantized leaf's codes) must match them."""
    if defs is not None:
        _check_defs(tree, defs)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if _is_quantized(t):
            return _quantized_leaf(t, device)
        return _to_tensor(t, device, dtype)

    return walk(tree)


def params_block_from_numpy(tree: Any, defs: Any, rt: Runtime, device,
                            dtype: torch.dtype | None = None) -> Any:
    """``params_from_numpy(tree, device, dtype, defs)`` cut to this rank's
    block of each leaf (``rt.local``): each leaf is cut on the host before
    it moves to ``device``."""
    host = params_from_numpy(tree, "cpu", dtype, defs=defs)

    def walk(t, d):
        if isinstance(t, dict):
            return {k: walk(v, d[k]) for k, v in t.items()}
        return rt.local(t, d).to(device)

    return walk(host, defs)


def _moments(tree: Any, device) -> Any:
    """A moment tree read back from a step dir, on ``device``. An int8
    moment is saved as its (codes, scales) pair, the leaves ``<path>.0``
    and ``<path>.1``; it comes back as that tuple, its types and the scales'
    shape (one per last-axis row) checked."""
    if isinstance(tree, dict) and set(tree) == {"0", "1"}:
        q, s = (_to_tensor(tree[i], device, None) for i in ("0", "1"))
        if (q.dtype != torch.int8 or s.dtype != torch.float32
                or s.shape != (*q.shape[:-1], 1)):
            raise ValueError(f"int8 moment {q.dtype} {tuple(q.shape)} with "
                             f"scales {s.dtype} {tuple(s.shape)}")
        return q, s
    if isinstance(tree, dict):
        return {k: _moments(v, device) for k, v in tree.items()}
    return _to_tensor(tree, device, None)


def state_from_step_dir(step_dir: str | Path, defs: Any, device) -> dict:
    """A ``step_N/`` checkpoint directory → ``{"params": tree, "opt": {"m":
    tree, "v": tree, "count": tensor}}`` on ``device`` (``"opt"`` only when
    the checkpoint holds one; int8 moments as (codes, scales) pairs).
    ``defs`` is the model's ``param_defs()``: the parameters and both
    moments must have its paths and shapes."""
    d = Path(step_dir)
    manifest = json.loads((d / "manifest.json").read_text())
    tree: dict = {}
    for key, meta in manifest["leaves"].items():
        *parents, name = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = from_numpy(np.load(d / meta["file"]), meta["dtype"])
    if "params" not in tree:
        raise ValueError(f"{d} holds no params leaves")
    out = {"params": params_from_numpy(tree["params"], device, defs=defs)}
    if "opt" in tree:
        opt = tree["opt"]
        out["opt"] = {m: _moments(opt[m], device) for m in ("m", "v")}
        for m in ("m", "v"):
            _check_defs(out["opt"][m], defs)
        out["opt"]["count"] = opt["count"].to(device)
    return out
