"""The train step (``repro.launch.steps.make_train_step``)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import faults
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (
    Runtime, iter_leaves, map_tree, torch_dtype,
)
from repro_torch.optim import OptConfig, apply_updates


def loss_and_grads(model, params, batch):
    """(loss, grads): the model's loss and its gradient for every leaf of
    ``params``, as a tree of the same paths in the leaves' types."""
    leaves = map_tree(lambda p: p.detach().requires_grad_(True), params)
    loss = model.loss(leaves, batch)
    flat = []
    map_tree(flat.append, leaves)
    grads = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), map_tree(lambda _: next(grads), leaves)


def sync_grads(grads, rt: Runtime | None, defs=None):
    """The data ranks' mean of each gradient leaf: a plain all-reduce over
    ``rt.dp_axes()`` in sorted-path order, in place, then over the group's
    size. What GSPMD gives the reference's sharded step; the parameters
    then stay equal on every data rank. ``grads`` itself without data
    ranks. A leaf that the rules split over a data axis (FSDP's ``embed``,
    given the params' ``defs``) already holds the sum over that axis (its
    gather's backward reduce-scatters), so it is all-reduced over the other
    data axes only before the division."""
    n = rt.dp_size if rt is not None else 1
    if n == 1:
        return grads
    dp = rt.dp_axes()
    leaf_defs = iter_leaves(defs) if defs is not None else None
    for _, g in iter_leaves(grads):
        axes = dp
        if leaf_defs is not None:
            split = rt.split_axes(next(leaf_defs)[1])
            axes = tuple(a for a in dp if a not in split)
        if axes:
            C.all_reduce_(g, axes, rt.mesh)
        g.div_(n)
    return grads


def make_train_step(model, opt_cfg: OptConfig, accum_steps: int = 1,
                    accum_dtype: str = "float32",
                    rt: Runtime | None = None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` with state
    ``{"params", "opt"}`` and metrics ``{"loss", "grad_norm", "lr"}``. The
    parameters and moments are updated in place (``optim.apply_updates``);
    the returned state holds the same tensors.

    ``accum_steps > 1`` splits the batch along dim 0 into microbatches run
    one after another; their grads add into a ``accum_dtype`` accumulator
    and the mean goes to the optimizer, as does the mean loss.

    On a mesh (``rt``, the model built on the same ``rt``) each rank's
    params are its blocks and its batch is its data rank's rows; its
    gradient is averaged over the data ranks (``sync_grads``) and AdamW
    clips by the whole model's norm (``optim.global_norm`` over the
    blocks).

    A runtime trip of the step's kernels (``faults.raise_pending``) raises
    before the optimizer writes anything: the params, the moments and the
    step count are as they were, and the grads (the accumulator too) are
    the step's own, so a retry of the same step starts from zero."""

    on_mesh = rt is not None and rt.mesh is not None
    defs = model.param_defs() if on_mesh else None
    blocks = dict(rt=rt, defs=defs) if on_mesh else {}  # AdamW on blocks

    def train_step(state, batch):
        params = state["params"]
        if accum_steps == 1:
            loss, grads = loss_and_grads(model, params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"grad_accum {accum_steps}")
            mb = b // accum_steps
            adt = torch_dtype(accum_dtype)
            grads = map_tree(lambda p: torch.zeros(p.shape, dtype=adt,
                                                   device=p.device), params)
            loss = 0.0
            for i in range(accum_steps):
                micro = {k: v[i * mb : (i + 1) * mb] for k, v in batch.items()}
                l_i, g_i = loss_and_grads(model, params, micro)
                loss = loss + l_i
                for (_, acc), (_, g) in zip(iter_leaves(grads),
                                            iter_leaves(g_i)):
                    acc.add_(g.to(adt))
                del g_i
            loss = loss / accum_steps
            for _, acc in iter_leaves(grads):
                acc.div_(accum_steps)
        faults.raise_pending(loss.device)
        grads = sync_grads(grads, rt, defs)
        new_p, new_opt, info = apply_updates(params, grads, state["opt"],
                                             opt_cfg, **blocks)
        return {"params": new_p, "opt": new_opt}, {"loss": loss, **info}

    return train_step
