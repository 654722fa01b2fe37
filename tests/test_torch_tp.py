"""The tensor-parallel and FSDP layout against the reference, on the CPU,
no process group.

``Runtime.placement`` is the reference ``Runtime``'s ``pspec`` on every
leaf of whisper, the decoders, llava and jamba, under ``DEFAULT_RULES`` and
``FSDP_RULES``, on the meshes the tests and the card run and on the
production shape (the reference's ``Runtime`` reads only ``axis_names``
and ``shape``, so a ``SimpleNamespace`` stands in for its mesh; its own
sharded run fails on jax 0.9 with a ``ShardingTypeError``, so the layout,
not its sharded numbers, is what is compared). Each rank's block of every
leaf, cut from the reference's initialized params by
``bridge.params_block_from_numpy``, is the slice of the whole leaf that
its placement names, and the ranks' blocks tile the leaf; mamba's
``in_proj`` is the one leaf whose block is two runs. rwkv6 refuses a
runtime that would split its leaves.
"""
import functools
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    DEFAULT_RULES, FSDP_RULES, Runtime, iter_leaves, mesh_axes,
)
from repro_torch.models import build_model  # noqa: E402

ARCHS = ("whisper-medium", "qwen3-1.7b", "llama3-8b", "gemma-2b",
         "granite-8b", "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b",
         "llava-next-34b", "jamba-1.5-large-398b")
MESHES = {"data2_model2": ((2, 2), ("data", "model")),
          "model4": ((1, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model"))}
RULES = {"default": DEFAULT_RULES, "fsdp": FSDP_RULES}


def _mesh(shape, names, coords=None):
    return SimpleNamespace(axis_names=tuple(names),
                           shape=dict(zip(names, shape)), coords=coords)


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_placement_is_the_references_pspec(arch, smoke, rules):
    from repro.distributed import sharding as ref

    cfg = get_config(arch)
    cfg = smoke_config(cfg) if smoke else cfg
    defs = dict(iter_leaves(build_model(cfg).param_defs()))
    for shape, names in MESHES.values():
        rt = Runtime(_mesh(shape, names), dict(RULES[rules]))
        ref_rt = ref.Runtime(_mesh(shape, names), dict(RULES[rules]))
        for path, d in defs.items():
            assert rt.placement(d) == tuple(ref_rt.pspec(d.axes, d.shape)), (
                path, shape)
            assert (d.runs == 2) == path.endswith("mamba/in_proj"), path


@functools.lru_cache(maxsize=None)
def _ref_numpy(arch):
    """The reference's initialized smoke params, as numpy (read only)."""
    import jax

    from repro.configs import get_config as ref_get, smoke_config as ref_smoke
    from repro.models import build_model as ref_build

    jm = ref_build(ref_smoke(ref_get(arch)))
    return jax.tree.map(np.asarray, jm.init(jax.random.key(0)))


def _expected_block(whole: np.ndarray, d, rt) -> np.ndarray:
    """The slice of ``whole`` that ``rt.placement`` names, read off the
    placement alone: per split dim, block ``index`` of ``size`` equal
    blocks; a ``runs`` last dim takes that block of each run."""
    out = whole
    for dim, entry in enumerate(rt.placement(d)):
        k = int(np.prod([rt.mesh.shape[a] for a in mesh_axes(entry)] or [1]))
        if k == 1:
            continue
        idx = rt.index(entry)
        runs = d.runs if dim == len(d.shape) - 1 else 1
        parts = np.split(out, runs, axis=dim)
        out = np.concatenate([np.split(p, k, axis=dim)[idx] for p in parts],
                             axis=dim)
    return out


@pytest.mark.parametrize("mesh_rules", ["data2_model2-fsdp", "model4-default",
                                        "data2_model2-default"])
@pytest.mark.parametrize("arch", ("whisper-medium", "qwen3-1.7b", "gemma-2b",
                                  "qwen3-moe-30b-a3b", "llava-next-34b",
                                  "jamba-1.5-large-398b"))
def test_rank_blocks_of_reference_params(arch, mesh_rules):
    """Every rank's block of every leaf of the reference-initialized smoke
    params (``params_block_from_numpy``) is the slice its placement names,
    and all ranks' blocks together hold each element of the leaf as many
    times as the mesh has replicas of that leaf."""
    from repro_torch.bridge import params_block_from_numpy

    mesh_name, rules = mesh_rules.split("-")
    shape, names = MESHES[mesh_name]
    raw = _ref_numpy(arch)
    model = build_model(smoke_config(get_config(arch)))
    defs = model.param_defs()
    whole = dict(iter_leaves(raw))
    counts = {k: np.zeros(v.shape, dtype=np.int64) for k, v in whole.items()}
    split_any = False
    for coords in itertools.product(*(range(s) for s in shape)):
        rt = Runtime(_mesh(shape, names, dict(zip(names, coords))),
                     dict(RULES[rules]))
        got = dict(iter_leaves(params_block_from_numpy(raw, defs, rt, "cpu")))
        for path, d in iter_leaves(defs):
            want = _expected_block(whole[path], d, rt)
            assert tuple(got[path].shape) == rt.block_shape(d) == want.shape
            np.testing.assert_array_equal(got[path].numpy(), want, err_msg=path)
            split_any |= want.shape != whole[path].shape
            # mark the elements this block holds
            ids = np.arange(whole[path].size).reshape(whole[path].shape)
            np.add.at(counts[path].reshape(-1),
                      _expected_block(ids, d, rt).reshape(-1), 1)
    assert split_any
    for path, c in counts.items():
        assert c.min() == c.max() >= 1, path


@pytest.mark.parametrize("mesh,rules,refuses", [
    ((1, 2), "default", True), ((2, 1), "fsdp", True),
    ((2, 2), "default", True), ((2, 1), "default", False),
    ((1, 1), "fsdp", False)])
def test_rwkv6_refuses_a_runtime_that_splits_it(mesh, rules, refuses):
    """rwkv6's heads_flat layout is a slice of its own: on a runtime that
    would split any of its leaves it raises, naming the ROADMAP item; with
    a model axis of one rank (and embed whole) it builds, as PR 34's data
    parallelism runs it."""
    cfg = smoke_config(get_config("rwkv6-1.6b"))
    rt = Runtime(_mesh(mesh, ("data", "model"), {"data": 0, "model": 0}),
                 dict(RULES[rules]))
    if refuses:
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            build_model(cfg, rt)
    else:
        assert build_model(cfg, rt).cfg is cfg


def test_int8_weight_serving_refuses_a_split_model():
    """int8 weights under tensor parallelism are not ported: the serve
    path's quantization raises on a model whose leaves are split."""
    from repro_torch.launch import serve

    cfg = smoke_config(get_config("jamba-1.5-large-398b"))
    rt = Runtime(_mesh((1, 2), ("data", "model"), {"data": 0, "model": 0}))
    with pytest.raises(NotImplementedError, match="int8 serving under TP"):
        serve.quantize_for_serving(build_model(cfg, rt), None,
                                   torch.zeros(1, 4, dtype=torch.int64))
