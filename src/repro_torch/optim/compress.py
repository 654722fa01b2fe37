"""int8 per-row quantization and the error-feedback gradient all-reduce
(``repro.optim.compress``).

``quantize_int8`` / ``dequantize_int8``: absmax over the last axis, the
scale ``max |x| / 127 + 1e-12`` in float32, codes ``round(x / s)`` (half to
even) with no clip. The int8 KV cache (``models.common.quantize_kv_leaf``)
and AdamW's int8 moments (``optim.adamw``) quantize through it.

``ef_allreduce_grads``: the compressed data-parallel mean of the ranks'
local gradients with error feedback, step for step the reference's
protocol. The reference's docstring calls the wire int8; its code sums the
codes as int32 (``psum`` of ``q.astype(int32)``), and so does this one. A
library function, as in the reference: no train step or CLI calls it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import map_tree


def quantize_int8(x: torch.Tensor, axes=(), mesh=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per last-axis-row absmax quantization: (q int8, scale float32 with
    the last axis kept as 1). ``axes``: mesh axes that split the last
    axis, over which the rows' absmax is the ranks' max (``pmax``), so
    the codes are the whole row's."""
    xf = x.float()
    if x.dim() == 0:
        s = xf.abs() / 127.0 + 1e-12
        return torch.round(xf / s).to(torch.int8), s
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if axes:
        amax = C.pmax(amax, axes, mesh)
    s = amax / 127.0 + 1e-12
    return torch.round(xf / s).to(torch.int8), s


def dequantize_int8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def ef_allreduce_grads(grads: Any, err: Any, mesh, dp_axes: tuple[str, ...]
                       ) -> tuple[Any, Any]:
    """Compressed mean of this rank's ``grads`` over ``dp_axes``: (mean
    grads in the gradients' dtypes, new error feedback in float32). ``err``
    is the error carried from the last call (``init_error_feedback``).

    Per leaf: the target ``g + e`` in float32; its row scale ``max |target|
    / 127 + 1e-12`` over the last axis, ``pmax``-ed over ``dp_axes`` so
    every rank quantizes on one grid; codes ``clip(round(target / s), -127,
    127)`` as int8; the new error ``target - q * s``; the codes summed over
    ``dp_axes`` as int32; the mean ``sum * s / n``, cast back."""
    n = mesh.axis_size(dp_axes)

    def leaf(g, e):
        target = g.float() + e
        if g.dim() == 0:
            s_local = target.abs() / 127.0 + 1e-12
        else:
            s_local = target.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
        s = C.pmax(s_local, dp_axes, mesh)  # shared grid
        q = torch.clamp(torch.round(target / s), -127, 127).to(torch.int8)
        new_e = target - q.float() * s
        summed = C.all_reduce_(q.to(torch.int32), dp_axes, mesh)
        return (summed.float() * s / n).to(g.dtype), new_e

    def walk(g, e):  # sorted keys: every rank calls in one order
        if isinstance(g, dict):
            pairs = {k: walk(g[k], e[k]) for k in sorted(g)}
            return ({k: m for k, (m, _) in pairs.items()},
                    {k: x for k, (_, x) in pairs.items()})
        return leaf(g, e)

    return walk(grads, err)


def init_error_feedback(params: Any) -> Any:
    """A zero float32 error for every leaf of ``params``."""
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
