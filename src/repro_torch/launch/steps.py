"""The train step (``repro.launch.steps.make_train_step``)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.sharding import iter_leaves, map_tree, torch_dtype
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


def make_train_step(model, opt_cfg: OptConfig, accum_steps: int = 1,
                    accum_dtype: str = "float32") -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` with state
    ``{"params", "opt"}`` and metrics ``{"loss", "grad_norm", "lr"}``. The
    parameters and moments are updated in place (``optim.apply_updates``);
    the returned state holds the same tensors.

    ``accum_steps > 1`` splits the batch along dim 0 into microbatches run
    one after another; their grads add into a ``accum_dtype`` accumulator
    and the mean goes to the optimizer, as does the mean loss."""

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
        new_p, new_opt, info = apply_updates(params, grads, state["opt"],
                                             opt_cfg)
        return {"params": new_p, "opt": new_opt}, {"loss": loss, **info}

    return train_step
