"""AdamW with float32, bfloat16 or blockwise int8 moment storage
(``repro.optim.adamw``).

All update math runs in float32; the storage type only sets the moments'
bytes at rest, and each parameter is written back in its own type. Weight
decay applies to leaves of two or more dims. ``state_dtype="int8"`` keeps
each moment as a (q int8, scale float32) pair, one scale per last-axis row
(``compress.quantize_int8``), with the second moment stored in sqrt space:
v spans twice the dynamic range of m, and int8 codes of v itself would
underflow to 0 where m survives.

The update is in place, leaf by leaf, as ``torch.optim`` does, where the
reference builds new trees: the parameters and moments passed in are
overwritten and returned, and each gradient leaf is dropped from its dict
once its parameter is updated. That saves memory: a functional update
would hold a second copy of every parameter and moment, so the peak is
the standing state plus one leaf's float32 transients. The values are
those of the reference's ``apply_updates``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import map_tree
from repro_torch.optim.compress import dequantize_int8, quantize_int8

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


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
    state_dtype: str = "float32"  # float32 | bfloat16 | int8


def _check_state_dtype(cfg: OptConfig) -> None:
    if cfg.state_dtype not in STATE_DTYPES:
        raise ValueError(f"optimizer state_dtype {cfg.state_dtype!r}; one of "
                         f"{sorted(STATE_DTYPES)}")


def _store(x: torch.Tensor, dtype: str, *, sqrt_space: bool = False):
    """A float32 moment in its storage form: a (q, scale) pair for int8
    (of sqrt(x) for the second moment), else a tensor of ``dtype``."""
    if dtype == "int8":
        return quantize_int8(torch.sqrt(x) if sqrt_space else x)
    return x.to(STATE_DTYPES[dtype])


def _load(x, dtype: str, *, sqrt_space: bool = False) -> torch.Tensor:
    """A stored moment back in float32."""
    if dtype == "int8":
        d = dequantize_int8(*x)
        return torch.square(d) if sqrt_space else d
    return x.float()


def _assign(stored, new) -> None:
    """Overwrite a stored moment (tensor or (q, scale) pair) in place."""
    if isinstance(stored, tuple):
        for s, n in zip(stored, new):
            s.copy_(n)
    else:
        stored.copy_(new)


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
    """Zero moments in their storage form, one leaf at a time."""
    _check_state_dtype(cfg)

    def zeros(sqrt_space):
        return map_tree(lambda p: _store(
            torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            cfg.state_dtype, sqrt_space=sqrt_space), params)

    any_leaf = _leaves(params)[0]
    return {"m": zeros(False), "v": zeros(True),
            "count": torch.zeros((), dtype=torch.int32, device=any_leaf.device)}


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: OptConfig):
    """One AdamW step with global-norm clipping, in place: ``params`` and
    the moments of ``opt_state`` are overwritten, and ``grads`` is emptied
    leaf by leaf as it is used. Returns (params, the optimizer state with
    the new count, {"grad_norm", "lr"})."""
    _check_state_dtype(cfg)
    sd = cfg.state_dtype
    count = opt_state["count"] + 1
    cf = count.float()
    lr = lr_at(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    c1 = 1 - torch.pow(cfg.b1, cf)
    c2 = 1 - torch.pow(cfg.b2, cf)

    def upd(p, g, m_s, v_s):
        g = g.float() * scale
        m = cfg.b1 * _load(m_s, sd) + (1 - cfg.b1) * g
        v = cfg.b2 * _load(v_s, sd, sqrt_space=True) + (1 - cfg.b2) * g * g
        del g
        _assign(m_s, _store(m, sd))
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        _assign(v_s, _store(v, sd, sqrt_space=True))
        del m, v
        pf = p.float()
        if p.dim() >= 2:
            step = step + cfg.weight_decay * pf
        p.copy_(pf - lr * step)

    def walk(p, g, m, v):
        for k in sorted(p):
            if isinstance(p[k], dict):
                walk(p[k], g[k], m[k], v[k])
            else:
                upd(p[k], g.pop(k), m[k], v[k])

    walk(params, grads, opt_state["m"], opt_state["v"])
    return params, {"m": opt_state["m"], "v": opt_state["v"], "count": count}, {
        "grad_norm": gnorm, "lr": lr,
    }
