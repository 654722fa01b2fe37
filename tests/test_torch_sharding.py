"""The mesh half of ``repro_torch.distributed.sharding`` against
``repro.distributed.sharding``, on the CPU, no process group.

The rule tables equal the reference's. ``pspec``, ``axis_for``,
``dp_axes`` and ``dp_size`` equal the reference ``Runtime``'s for every
ParamDef of the ten configs (full and smoke) on the production meshes'
shapes: the reference's ``Runtime`` reads only ``mesh.axis_names`` and
``mesh.shape``, so a ``SimpleNamespace`` stands in for a mesh of devices
on both sides. Then the port's own layout: ``placement`` is ``pspec``
(a ``runs`` leaf split run by run), ``local`` cuts a rank's block, and the
ranked ``init_params`` draw gives each rank the block of the one-rank draw
bit for bit, the bounded draw (``MAX_DRAW`` monkeypatched small) included.
"""
import itertools
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import PORTED_ARCHS, get_config, smoke_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    DEFAULT_RULES, FSDP_RULES, ParamDef, Runtime, abstract_params, init_params,
    iter_leaves, torch_dtype,
)
from repro_torch.models import build_model  # noqa: E402

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape, names, coords=None):
    return SimpleNamespace(axis_names=tuple(names),
                           shape=dict(zip(names, shape)), coords=coords)


def test_rule_tables_equal_the_reference():
    from repro.distributed import sharding as ref

    assert DEFAULT_RULES == ref.DEFAULT_RULES
    assert FSDP_RULES == ref.FSDP_RULES


def _ref_defs(arch, smoke):
    from repro.configs import get_config as ref_get, smoke_config as ref_smoke
    from repro.distributed.sharding import ParamDef as RefDef, Runtime as RefRt
    from repro.models import build_model as ref_build

    cfg = ref_get(arch)
    cfg = ref_smoke(cfg) if smoke else cfg
    defs = ref_build(cfg, RefRt()).param_defs()
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(
        defs, is_leaf=lambda x: isinstance(x, RefDef))[0]
    return {"/".join(str(k.key) for k in path): d for path, d in leaves}


@pytest.mark.parametrize("rules", ["default", "fsdp"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(PORTED_ARCHS))
def test_rules_match_reference_runtime(arch, smoke, mesh_name, rules):
    """Every ParamDef of the config: the same paths, shapes and axes as the
    reference's, and the same pspec, axis_for per dim, dp_axes, dp_size and
    axis_size per logical axis."""
    from repro.distributed import sharding as ref

    shape, names = MESHES[mesh_name]
    table = DEFAULT_RULES if rules == "default" else FSDP_RULES
    rt = Runtime(_mesh(shape, names), dict(table))
    ref_rt = ref.Runtime(_mesh(shape, names), dict(table))
    cfg = get_config(arch)
    cfg = smoke_config(cfg) if smoke else cfg
    got = dict(iter_leaves(build_model(cfg).param_defs()))
    want = _ref_defs(arch, smoke)
    assert sorted(got) == sorted(want)
    for path, d in got.items():
        w = want[path]
        assert (d.shape, d.axes) == (tuple(w.shape), tuple(w.axes)), path
        assert rt.pspec(d.axes, d.shape) == tuple(ref_rt.pspec(w.axes, w.shape)), path
        for ax, n in zip(d.axes, d.shape):
            assert rt.axis_for(ax, n) == ref_rt.axis_for(ax, n), (path, ax, n)
    assert rt.dp_axes() == ref_rt.dp_axes()
    assert rt.dp_size == ref_rt.dp_size
    for logical in table:
        assert rt.axis_size(logical) == ref_rt.axis_size(logical), logical


def test_no_mesh_runtime_is_one_rank():
    from repro.distributed import sharding as ref

    rt, ref_rt = Runtime(), ref.Runtime()
    d = ParamDef((8, 4), ("experts", "embed"))
    assert rt.pspec(d.axes, d.shape) == tuple(ref_rt.pspec(d.axes, d.shape))
    assert rt.dp_axes() == ref_rt.dp_axes() == ()
    assert rt.dp_size == ref_rt.dp_size == 1
    assert rt.axis_for("experts", 8) is None
    assert rt.block(d) is None
    t = torch.arange(32.0).reshape(8, 4)
    assert rt.local(t, d) is t
    x = torch.ones(3)
    assert rt.constrain(x, "batch") is x


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-1.5-large-398b",
                                  "gemma-2b"])
def test_placement_is_the_rule_tables_pspec(arch):
    """On (data 2, model 2) under both rule tables every leaf is held in
    its ``pspec`` layout: heads, kv heads (head_dim for gemma's one KV
    head), mlp, vocab, conv_inner and experts over model, FSDP's embed over
    data. A rank's block is one run a split dim, except mamba's
    ``in_proj``, whose x and z halves each give the rank its run of them.
    A cache's batch axis splits over data; experts that the model axis
    does not divide stay whole."""
    cfg = get_config(arch)
    defs = dict(iter_leaves(build_model(cfg).param_defs()))
    for table in (DEFAULT_RULES, FSDP_RULES):
        rt = Runtime(_mesh((2, 2), ("data", "model"),
                           {"data": 1, "model": 1}), dict(table))
        for path, d in defs.items():
            spec = rt.placement(d)
            assert spec == rt.pspec(d.axes, d.shape), path
            pieces = rt.pieces(d)
            if not any(spec):
                assert pieces is None, path
                continue
            runs = [len(p) for p in pieces]
            if path.endswith("mamba/in_proj"):
                di = d.shape[-1] // 2
                assert pieces[-1] == ((di // 2, di // 2), (di + di // 2, di // 2))
                assert runs[:-1] == [1] * (len(runs) - 1)
            else:
                assert runs == [1] * len(runs), path
        split = {p for p, d in defs.items() if any(rt.placement(d))}
        assert "embed/tok" in split
        if table is FSDP_RULES:
            assert rt.placement(defs["final_norm"]) == ("data",)
        else:
            assert "final_norm" not in split
    if arch == "gemma-2b":
        rt = Runtime(_mesh((2, 2), ("data", "model")))
        assert rt.placement(defs["blocks/attn/wk"]) == (None, None, None, "model")
        assert rt.placement(defs["blocks/attn/wq"]) == (None, None, "model", None)
    cache = ParamDef((4, 8, 64, 4, 128),
                     ("layers", "batch", "kv_seq", "kv_heads", None))
    rt = Runtime(_mesh((2, 2), ("data", "model")))
    assert rt.placement(cache) == (None, "data", None, "model", None)
    assert rt.placement(ParamDef((3, 4), ("experts", None))) == (None, None)


@pytest.mark.parametrize("names,shape,entry_axes", [
    (("data", "model"), (2, 4), "model"),
    (("pod", "data", "model"), (2, 2, 2), None),
])
def test_local_is_the_ranks_block(names, shape, entry_axes):
    """``local`` cuts each rank's block along the split dim; the blocks of
    all ranks along the axis tile the whole leaf. A tuple entry (batch over
    (pod, data)) combines the coordinates row-major."""
    whole = torch.arange(8 * 3 * 5, dtype=torch.float32).reshape(8, 3, 5)
    if entry_axes == "model":
        d = ParamDef((8, 3, 5), ("experts", None, "embed"))
        n = shape[-1]
    else:
        d = ParamDef((8, 3, 5), ("batch", None, None))
        n = shape[0] * shape[1]
    blocks = {}
    for coords in itertools.product(*(range(s) for s in shape)):
        rt = Runtime(_mesh(shape, names, dict(zip(names, coords))))
        blk = rt.local(whole, d)
        size = 8 // n
        i = rt.index(rt.placement(d)[0])
        assert blk.shape == (size, 3, 5)
        assert torch.equal(blk, whole[i * size:(i + 1) * size])
        assert rt.block(d)[0] == (i * size, size)
        blocks[i] = blk
    assert torch.equal(torch.cat([blocks[i] for i in range(n)]), whole)
    # an int8 moment's scales (last dim 1) are cut along the same dim
    rt = Runtime(_mesh(shape, names, {a: 1 for a in names}))
    scales = torch.rand(8, 3, 1)
    assert rt.local(scales, d).shape == (8 // n, 3, 1)


def _moe_defs():
    cfg = smoke_config(get_config("qwen3-moe-30b-a3b")).replace(
        param_dtype="bfloat16", num_experts=8)
    return dict(build_model(cfg).param_defs(), extra={
        "big": ParamDef((3, 8, 40, 33), (None, "experts", None, None),
                        init="fan_in"),
        "vec": ParamDef((5000,), ("embed",), init="small"),
    }), "bfloat16"


@pytest.mark.parametrize("bound", ["module", "small"])
def test_ranked_init_is_the_whole_draws_block(bound, monkeypatch):
    """Each rank of (data 2, model 2) draws the leaves in the one-rank
    order and slices and keeps its block: equal to the same block of the
    one-rank draw bit for bit, the generator left where the one-rank draw
    leaves it; with a bound under the largest leaf the draws are sliced
    and none exceeds it."""
    defs, dtype = _moe_defs()
    if bound == "small":
        monkeypatch.setattr(sharding, "MAX_DRAW", 2000)
    whole = dict(iter_leaves(init_params(defs, torch.Generator().manual_seed(4),
                                         dtype)))
    gen = torch.Generator().manual_seed(4)
    init_params(defs, gen, dtype)
    after = torch.randn(3, generator=gen)
    sizes = []
    real = torch.randn

    def spy(*shape, **kw):
        out = real(*shape, **kw)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", spy)
    for coords in itertools.product(range(2), range(2)):
        rt = Runtime(_mesh((2, 2), ("data", "model"),
                           dict(zip(("data", "model"), coords))))
        gen = torch.Generator().manual_seed(4)
        got = dict(iter_leaves(init_params(defs, gen, dtype, rt)))
        for path, d in iter_leaves(defs):
            want = rt.local(whole[path], d)
            assert got[path].dtype == torch_dtype(d.dtype or dtype), path
            assert torch.equal(got[path], want), (path, coords)
            if any(rt.placement(d)):
                assert got[path].shape[rt.placement(d).index("model")] == \
                    d.shape[rt.placement(d).index("model")] // 2
        assert torch.equal(real(3, generator=gen), after)
    if bound == "small":
        assert max(sizes) <= 2000


def test_abstract_params_are_meta_tensors():
    defs, dtype = _moe_defs()
    ab = dict(iter_leaves(abstract_params(defs, dtype)))
    for path, d in iter_leaves(defs):
        t = ab[path]
        assert t.device.type == "meta"
        assert tuple(t.shape) == d.shape
        assert t.dtype == torch_dtype(d.dtype or dtype)
    assert sum(math.prod(t.shape) for t in ab.values()) == sum(
        math.prod(d.shape) for _, d in iter_leaves(defs))
