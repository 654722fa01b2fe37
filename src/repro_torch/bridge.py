"""Carry weights across from the JAX reference.

``params_from_numpy`` turns the reference's parameter pytree, handed over
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on
the JAX side), into this package's nested dict of tensors with the same
paths. JAX's random generator cannot be reproduced in torch, so parity
tests build the weights once in the reference and move them here.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.distributed.sharding import ParamDef, iter_leaves


def _to_tensor(a: Any, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: torch has no numpy bf16
        t = torch.from_numpy(a.view(np.uint16).astype(np.int32) << 16)
        t = t.view(torch.float32).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))  # owned and writable
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Any, device, dtype: torch.dtype | None = None,
                      defs: Any = None) -> Any:
    """Nested dict of numpy arrays → nested dict of tensors on ``device``
    (cast to ``dtype`` when given). With ``defs`` (the model's
    ``param_defs()``), the paths and every leaf's shape must match them."""
    if defs is not None:
        want = {p: d.shape for p, d in iter_leaves(defs)
                if isinstance(d, ParamDef)}
        got = {p: tuple(np.shape(a)) for p, a in iter_leaves(tree)}
        if want != got:
            missing = sorted(set(want) - set(got))
            extra = sorted(set(got) - set(want))
            wrong = sorted(p for p in set(want) & set(got) if want[p] != got[p])
            raise ValueError(
                f"param tree does not match the model's defs: missing "
                f"{missing}, unexpected {extra}, shape mismatch "
                f"{[(p, got[p], want[p]) for p in wrong]}"
            )

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _to_tensor(t, device, dtype)

    return walk(tree)
