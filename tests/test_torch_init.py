"""``repro_torch.distributed.sharding.init_params`` and its bounded float32
draw (``sharding.MAX_DRAW``), on the CPU.

With the module's bound, or any bound no leaf exceeds, every leaf is the
one whole draw it always was (held here to a copy of that rule, bit for
bit). With a smaller bound (set here with a monkeypatch) a leaf is filled
a slice of its leading axes at a time:
no ``torch.randn`` call draws more than the bound, each leaf keeps its
scale, and one seed gives one tree.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    ParamDef, init_params, iter_leaves, torch_dtype,
)
from repro_torch.models import build_model  # noqa: E402


def _whole_draws(defs, gen, default_dtype):
    """Every leaf as one whole float32 draw, scaled, then cast: the rule
    ``init_params`` follows for a leaf within the bound."""
    out = {}
    for path, d in iter_leaves(defs):
        dtype = torch_dtype(d.dtype or default_dtype)
        if d.init in ("zeros", "ones"):
            t = (torch.zeros if d.init == "zeros" else torch.ones)(d.shape, dtype=dtype)
        else:
            scale = d.scale if d.scale is not None else {
                "normal": 0.02, "small": 0.01}.get(
                    d.init, 1.0 / max(d.shape[0] if d.shape else 1, 1) ** 0.5)
            t = torch.randn(d.shape, generator=gen, dtype=torch.float32)
            t = t.mul_(scale).to(dtype)
        out[path] = t
    return out


def _defs():
    """qwen3-moe's smoke tree (router, experts, qk norms) in bf16, and a
    few leaves of other shapes and rules."""
    cfg = smoke_config(get_config("qwen3-moe-30b-a3b")).replace(
        param_dtype="bfloat16")
    return dict(build_model(cfg).param_defs(), extra={
        "vec": ParamDef((5000,), ("embed",), init="small"),
        "cube": ParamDef((3, 7, 64, 33), (None, None, None, None),
                         init="fan_in"),
        "fixed": ParamDef((40, 50), (None, None), scale=0.5),
    }), "bfloat16"


def _largest(defs):
    return max(math.prod(d.shape) for _, d in iter_leaves(defs))


@pytest.mark.parametrize("bound", ["module", "largest", "huge"])
def test_unbounded_draw_is_the_whole_leaf_draw(bound, monkeypatch):
    defs, dtype = _defs()
    if bound == "module":
        assert sharding.MAX_DRAW >= _largest(defs)
    else:
        monkeypatch.setattr(sharding, "MAX_DRAW", {
            "largest": _largest(defs), "huge": 10 ** 12}[bound])
    got = dict(iter_leaves(init_params(defs, torch.Generator().manual_seed(3),
                                       dtype)))
    want = _whole_draws(defs, torch.Generator().manual_seed(3), dtype)
    assert set(got) == set(want)
    for path, t in want.items():
        assert got[path].dtype == t.dtype and torch.equal(got[path], t), path


@pytest.mark.parametrize("max_draw", [1000, 4096, 30000])
def test_bounded_draw_never_draws_more_than_the_bound(max_draw, monkeypatch):
    defs, dtype = _defs()
    assert _largest(defs) > max_draw
    sizes = []
    randn = torch.randn

    def counting(*args, **kw):
        t = randn(*args, **kw)
        sizes.append(t.numel())
        return t

    monkeypatch.setattr(sharding.torch, "randn", counting)
    monkeypatch.setattr(sharding, "MAX_DRAW", max_draw)
    params = init_params(defs, torch.Generator().manual_seed(5), dtype)
    assert sizes and max(sizes) <= max_draw
    drawn = sum(math.prod(d.shape) for _, d in iter_leaves(defs)
                if d.init not in ("zeros", "ones"))
    assert sum(sizes) == drawn  # each element drawn once
    want = dict(iter_leaves(defs))
    for path, t in iter_leaves(params):
        d = want[path]
        assert tuple(t.shape) == d.shape
        assert t.dtype == torch_dtype(d.dtype or dtype), path


def test_bounded_draw_keeps_each_leaf_scale_and_seed(monkeypatch):
    """Every drawn leaf's std within 2% of its scale (the whole leaf's
    fan-in rule, shape[0] of the stored leaf), the zeros and ones as they
    are; two draws from one seed equal, another seed differs."""
    defs = {
        "experts": ParamDef((4, 8, 96, 80), (None, None, None, None),
                            init="fan_in"),
        "router": ParamDef((96, 128), (None, None), init="normal",
                           dtype="float32"),
        "norm": ParamDef((96,), (None,), init="ones"),
        "bias": ParamDef((96,), (None,), init="zeros"),
        "wide": ParamDef((3, 20000), (None, None), init="small"),
    }
    scales = {"experts": 0.5, "router": 0.02, "wide": 0.01}
    monkeypatch.setattr(sharding, "MAX_DRAW", 2000)
    a = init_params(defs, torch.Generator().manual_seed(9), "bfloat16")
    for name, s in scales.items():
        std = a[name].float().std().item()
        assert abs(std - s) <= 0.02 * s, (name, std, s)
    assert a["experts"].dtype == torch.bfloat16
    assert a["router"].dtype == torch.float32
    assert torch.equal(a["norm"], torch.ones(96, dtype=torch.bfloat16))
    assert not a["bias"].any()
    b = init_params(defs, torch.Generator().manual_seed(9), "bfloat16")
    c = init_params(defs, torch.Generator().manual_seed(10), "bfloat16")
    for name in defs:
        assert torch.equal(a[name], b[name]), name
    assert not torch.equal(a["experts"], c["experts"])


def test_model_init_draws_within_the_bound(monkeypatch):
    """``DenseLM.init(gen)``, as the serve and train CLIs call it, draws
    within the module's bound."""
    cfg = smoke_config(get_config("qwen3-moe-30b-a3b"))
    model = build_model(cfg)
    sizes = []
    randn = torch.randn

    def counting(*args, **kw):
        t = randn(*args, **kw)
        sizes.append(t.numel())
        return t

    monkeypatch.setattr(sharding.torch, "randn", counting)
    model.init(torch.Generator().manual_seed(0))
    assert max(sizes) == _largest(model.param_defs()) > 5000
    sizes.clear()
    monkeypatch.setattr(sharding, "MAX_DRAW", 5000)
    model.init(torch.Generator().manual_seed(0))
    assert max(sizes) <= 5000
