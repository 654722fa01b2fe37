"""AdamW with float32 or bfloat16 moment storage (``repro.optim.adamw``).

All update math runs in float32; the storage type only sets the moments'
bytes at rest, and each parameter is written back in its own type. Weight
decay applies to leaves of two or more dims. The reference's third storage
type, blockwise int8 moments (``state_dtype="int8"``, which needs
``repro.optim.compress``), is not ported yet and raises.

Trees are nested dicts of tensors; ``apply_updates`` returns new trees and
leaves its arguments as they were, as the reference does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import map_tree

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"  # float32 | bfloat16 (int8: not ported)


def _state_dtype(cfg: OptConfig) -> torch.dtype:
    if cfg.state_dtype not in STATE_DTYPES:
        raise NotImplementedError(
            f"optimizer state_dtype {cfg.state_dtype!r} is not ported yet; "
            f"ported: {sorted(STATE_DTYPES)}")
    return STATE_DTYPES[cfg.state_dtype]


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine decay to
    ``min_lr_ratio · lr`` at ``total_steps``; float32."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = cfg.lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _leaves(tree) -> list[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in _leaves(tree)))


def init_opt_state(params, cfg: OptConfig) -> dict:
    dt = _state_dtype(cfg)

    def zeros():
        return map_tree(lambda p: torch.zeros(p.shape, dtype=dt,
                                              device=p.device), params)

    any_leaf = _leaves(params)[0]
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=any_leaf.device)}


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: OptConfig):
    """One AdamW step with global-norm clipping. Returns (new params, new
    optimizer state, {"grad_norm", "lr"})."""
    dt = _state_dtype(cfg)
    count = opt_state["count"] + 1
    cf = count.float()
    lr = lr_at(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    c1 = 1 - torch.pow(cfg.b1, cf)
    c2 = 1 - torch.pow(cfg.b2, cf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        pf = p.float()
        if p.dim() >= 2:
            step = step + cfg.weight_decay * pf
        return (pf - lr * step).to(p.dtype), m.to(dt), v.to(dt)

    def walk(p, g, m, v):
        if isinstance(p, dict):
            outs = {k: walk(p[k], g[k], m[k], v[k]) for k in p}
            return tuple({k: o[i] for k, o in outs.items()} for i in range(3))
        return upd(p, g, m, v)

    new_p, new_m, new_v = walk(params, grads, opt_state["m"], opt_state["v"])
    return new_p, {"m": new_m, "v": new_v, "count": count}, {
        "grad_norm": gnorm, "lr": lr,
    }
