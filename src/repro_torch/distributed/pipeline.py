"""Pipeline parallelism: the GPipe microbatch schedule over a ``stage`` mesh
axis (``repro.distributed.pipeline``), over ``torch.distributed``.

S stages × M microbatches in M + S − 1 steps, bubble fraction
(S − 1)/(M + S − 1). At step t stage 0 takes microbatch t (while t < M),
every stage applies its own weights to what it holds, the last stage emits
microbatch t − S + 1 (when in range), and each stage hands its output to
the next (``collectives.ppermute``). The outputs are then summed over the
stage group, the last stage's alone non-zero, so every rank returns them.

``pipeline_apply(stage_fn, stage_params, x, mesh)``:
  * ``stage_params``: this rank's stage's weights (the reference takes
    the (S, ...) stack sharded over ``stage``; its per-device block is
    this);
  * ``x``: (M, mb, ...) microbatched input, the same on every rank;
  * returns (M, mb, ...) outputs of the full S-stage composition.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed import collectives as C


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, mesh, *,
                   stage_axis: str = "stage") -> torch.Tensor:
    """Run the S-stage pipeline over M microbatches (forward)."""
    n_stages = mesh.axis_size(stage_axis)
    M = x.shape[0]
    steps = M + n_stages - 1  # schedule length incl. fill/drain bubble
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    stage_id = C.axis_index(stage_axis, mesh)
    last = stage_id == n_stages - 1
    buf = torch.zeros_like(x[0])  # incoming activation
    outs = torch.zeros_like(x)
    for t in range(steps):
        cur = x[t] if stage_id == 0 and t < M else buf
        y = stage_fn(stage_params, cur)
        m_out = t - (n_stages - 1)
        if last and 0 <= m_out < M:
            outs[m_out] = y
        buf = C.ppermute(y, stage_axis, perm, mesh)
    return C.psum(outs, stage_axis, mesh)


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
