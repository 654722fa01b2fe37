"""The tensor-parallel and FSDP layout across gloo ranks on the CPU: the
clip norm of a split model, the int8 moments' and the int8 KV cache's row
scales, mamba's two-run ``in_proj``, the expert F split of the 2-D rules,
and elastic checkpoints, each against the port's one-rank run.

Two runs of (data 2, model 2) ranks (the clip norm's step on its own, as
it runs on any tree since the mesh runtime) and one of (model 2) ranks
make every rank-side result (``run_ranks``, 120-s ``timeout_s``); the
tests compare them with one-rank runs in the parent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_common as T  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

# the step's params are p - lr * update with |p| up to 0.1: a last-bit
# difference of the update moves them by float32 steps of 2**-27 there
STEP_ATOL = 4 * 2.0 ** -27


def _moe_cfg():
    """qwen3-moe's smoke config at capacity factor 8 (no drops)."""
    from repro_torch.configs import get_config, smoke_config

    return smoke_config(get_config("qwen3-moe-30b-a3b")).replace(
        capacity_factor=8.0)


def _jamba_cfg():
    from repro_torch.configs import get_config, smoke_config

    return smoke_config(get_config("jamba-1.5-large-398b")).replace(
        num_experts=0)


def _ep2d_cfg():
    from repro_torch.configs import get_config, smoke_config

    return smoke_config(get_config("phi3.5-moe-42b-a6.6b")).replace(
        d_model=32, d_ff=64, num_experts=8, experts_per_token=2,
        capacity_factor=8.0)


def _rules(name):
    from repro_torch.distributed.sharding import DEFAULT_RULES, FSDP_RULES

    return {"default": dict(DEFAULT_RULES), "fsdp": dict(FSDP_RULES),
            # the reference's serving 2-D rules (launch/dryrun.py), as far as
            # the MoE FFN reads them
            "2d": dict(DEFAULT_RULES, batch=None, mlp=("model", "data"))}[name]


def _int8_state(defs, rt):
    """A jamba smoke state: the params and an AdamW gradient tree, each
    the rank's block of a one-rank draw, and zero int8 moments."""
    from repro_torch.distributed.sharding import init_params
    from repro_torch.optim import OptConfig, init_opt_state

    params = init_params(defs, torch.Generator().manual_seed(3), "float32", rt)
    grads = init_params(defs, torch.Generator().manual_seed(4), "float32", rt)
    cfg = OptConfig(state_dtype="int8", **T.OPT)
    return params, grads, init_opt_state(params, cfg), cfg


def _int8_step(rt, defs):
    """One int8-moment AdamW step of ``_int8_state``: every moment's codes
    and row scales and every param, gathered whole."""
    from repro_torch.distributed.sharding import iter_leaves
    from repro_torch.optim import apply_updates

    params, grads, opt, cfg = _int8_state(defs, rt)
    params, opt, _ = apply_updates(params, grads, opt, cfg, rt, defs)
    flat = dict(iter_leaves(defs))
    out = {f"p/{k}": rt.gather(t, flat[k]).numpy()
           for k, t in iter_leaves(params)}
    for m in ("m", "v"):
        for k, (q, s) in iter_leaves(opt[m]):
            out[f"{m}/{k}/q"] = rt.gather(q, flat[k]).numpy()
            out[f"{m}/{k}/s"] = rt.gather(s, flat[k]).numpy()
    return out, params, opt


def _norm_rank(mesh):
    """(data 2, model 2): one synced AdamW step of qwen3-moe's smoke
    config, its data rank's rows: (clip norm, this rank's params)."""
    from repro_torch.distributed.sharding import Runtime, iter_leaves
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig, init_opt_state

    rt = Runtime(mesh)
    i = mesh.coords["data"]
    model = build_model(_moe_cfg(), rt)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v[2 * i:2 * i + 2])
             for k, v in T.family_batch("qwen3-moe-30b-a3b", model.cfg).items()}
    opt_cfg = OptConfig(**T.OPT)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    state, metrics = make_train_step(model, opt_cfg, rt=rt)(state, batch)
    return dict(rank=mesh.rank, coords=dict(mesh.coords),
                grad_norm=float(metrics["grad_norm"]),
                stepped={k: t.numpy() for k, t in iter_leaves(state["params"])})


def _grid_rank(mesh, ckpt):
    """(data 2, model 2): the two-run in_proj, the 2-D rules' MoE, and an
    int8-moment step under FSDP, whose state is saved elastically to
    ``ckpt``."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed.sharding import Runtime, iter_leaves, map_tree
    from repro_torch.models import build_model, moe as moe_lib

    out = {"rank": mesh.rank, "coords": dict(mesh.coords)}
    # the two-run in_proj, gathered whole, under both rule tables
    for rules in ("default", "fsdp"):
        rtj = Runtime(mesh, _rules(rules))
        jm = build_model(_jamba_cfg(), rtj)
        d = jm.param_defs()["periods"]["pos0"]["mamba"]["in_proj"]
        p = jm.init(torch.Generator().manual_seed(1))
        blk = p["periods"]["pos0"]["mamba"]["in_proj"]
        out[f"in_proj_{rules}"] = (tuple(blk.shape),
                                   rtj.gather(blk, d).numpy())
    # the expert F split of the 2-D rules: forward and backward
    rt2 = Runtime(mesh, _rules("2d"))
    cfg = _ep2d_cfg()
    defs = moe_lib.moe_defs(cfg)
    p = map_tree(lambda t: t.requires_grad_(True), _ranked_init(defs, rt2, 5))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 32, 32)).astype(np.float32)).requires_grad_(True)
    y, aux = moe_lib.moe_apply(p, x, cfg, rt2)
    w = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 32, 32)).astype(np.float32))
    ((y * w).sum() + aux).backward()
    flat = dict(iter_leaves(defs))
    out["ep2d"] = dict(y=y.detach().numpy(), aux=aux.item(),
                       dx=x.grad.numpy(), wg_block=tuple(p["wg"].shape),
                       grads={k: rt2.gather(t.grad, flat[k]).numpy()
                              for k, t in iter_leaves(p)})
    # int8 moments under FSDP, then the elastic save of that state
    rtf = Runtime(mesh, _rules("fsdp"))
    jdefs = build_model(_jamba_cfg(), rtf).param_defs()
    out["int8_fsdp"], params, opt = _int8_step(rtf, jdefs)
    CheckpointManager(ckpt).save(1, {"params": params, "opt": opt}, rt=rtf,
                                 defs=_state_defs(jdefs))
    return out


def _state_defs(defs):
    return {"params": defs, "opt": {"m": defs, "v": defs, "count": None}}


def _ranked_init(defs, rt, seed):
    from repro_torch.distributed.sharding import init_params

    return init_params(defs, torch.Generator().manual_seed(seed), "float32", rt)


def _model_rank(mesh, ckpt):
    """(model 2): the int8 KV cache of gemma (its whole KV head) and
    qwen3, an int8-moment step, and the FSDP-saved state restored on this
    mesh, gathered whole and saved again."""
    from repro_torch.checkpoint.manager import (
        CheckpointManager, _flatten, _flatten_defs,
    )
    from repro_torch.distributed.sharding import Runtime
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    rt = Runtime(mesh)
    out = {"rank": mesh.rank}
    for arch in ("gemma-2b", "qwen3-1.7b"):
        cfg = T.family_cfg(arch).replace(kv_quant="int8")
        model = build_model(cfg, rt)
        params = model.init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            logits, cache = serve.prefill_cache(
                model, params, torch.from_numpy(T.prompts(cfg)), cache_len=16)
        out[f"kv_{arch}"] = (logits.numpy(),
                             {k: t.numpy() for k, t in cache.items()})
    jdefs = build_model(_jamba_cfg(), rt).param_defs()
    out["int8_model"], _, _ = _int8_step(rt, jdefs)
    params, _, opt, _ = _int8_state(jdefs, rt)
    sdefs = _state_defs(jdefs)
    mgr = CheckpointManager(ckpt)
    got = mgr.restore(1, {"params": params, "opt": opt}, rt=rt, defs=sdefs)
    fd = _flatten_defs(got, sdefs)
    out["restored"] = {k: rt.gather(t, fd[k]).numpy() if fd[k] is not None
                       else t.numpy() for k, t in _flatten(got).items()}
    mgr.save(2, got, rt=rt, defs=sdefs)
    return out


@pytest.fixture(scope="module")
def norm_runs(tmp_path_factory):
    return run_ranks(_norm_rank, 2, 2, device="cpu", backend="gloo",
                     rdv_dir=tmp_path_factory.mktemp("rdv"),
                     timeout_s=T.TIMEOUT)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    res = run_ranks(_grid_rank, 2, 2, device="cpu", backend="gloo",
                    rdv_dir=tmp_path_factory.mktemp("rdv"), args=(str(ckpt),),
                    timeout_s=T.TIMEOUT)
    return res, ckpt


@pytest.fixture(scope="module")
def model2(grid, tmp_path_factory):
    _, ckpt = grid
    return run_ranks(_model_rank, 1, 2, device="cpu", backend="gloo",
                     rdv_dir=tmp_path_factory.mktemp("rdv"),
                     args=(str(ckpt),), timeout_s=T.TIMEOUT)


def _local(t, d, coords):
    from types import SimpleNamespace

    from repro_torch.distributed.sharding import Runtime

    names = tuple(coords)
    shape = {"data": 2, "model": 2} if len(names) == 2 else {"model": 2}
    rt = Runtime(SimpleNamespace(axis_names=names, shape=shape,
                                 coords=coords))
    return rt.local(torch.from_numpy(np.asarray(t)), d).numpy()


def test_clip_norm_and_step_match_one_rank(norm_runs):
    """qwen3-moe's smoke config on (data 2, model 2), experts, heads and
    vocabulary split over model: one synced AdamW step clips by a norm
    equal on every rank and within 1e-6 of the one-rank norm, and each
    rank's params are its block of AdamW's update of the one-rank params
    by the one-rank gradient of the same objective. (Summing only the
    squares a rank holds gives each model rank another norm.)"""
    from repro_torch.distributed.sharding import iter_leaves, map_tree
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig, init_opt_state

    res = norm_runs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = build_model(_moe_cfg())
        params = model.init(torch.Generator().manual_seed(0))
        batch = {k: torch.from_numpy(v) for k, v in
                 T.family_batch("qwen3-moe-30b-a3b", model.cfg).items()}
        model.loss = lambda p, b: T._moe_shard_loss(model, p, b, 2)
        opt_cfg = OptConfig(**T.OPT)
        state = {"params": map_tree(torch.clone, params),
                 "opt": init_opt_state(params, opt_cfg)}
        state, metrics = steps.make_train_step(model, opt_cfg)(state, batch)
    finally:
        torch.set_num_threads(threads)
    norm = float(metrics["grad_norm"])
    defs = dict(iter_leaves(model.param_defs()))
    for r in res:
        assert r["grad_norm"] == res[0]["grad_norm"], r["rank"]
        assert abs(r["grad_norm"] - norm) <= 1e-6 * norm, (r["grad_norm"], norm)
        for k, p in iter_leaves(state["params"]):
            np.testing.assert_allclose(r["stepped"][k],
                                       _local(p.numpy(), defs[k], r["coords"]),
                                       rtol=1e-6, atol=STEP_ATOL, err_msg=k)


@pytest.mark.parametrize("rules", ["default", "fsdp"])
def test_two_run_in_proj_gathers_to_the_one_rank_draw(grid, rules):
    """mamba's in_proj (d, 2·di): each model rank holds its run of the x
    half and its run of the z half, (d, di) of the (d, 2·di) (under FSDP
    half of d too); gathered whole it is the one-rank draw bit for bit."""
    from repro_torch.models import build_model

    res, _ = grid
    model = build_model(_jamba_cfg())
    whole = model.init(torch.Generator().manual_seed(1))
    want = whole["periods"]["pos0"]["mamba"]["in_proj"].numpy()
    P, d, di2 = want.shape
    for r in res:
        shape, got = r[f"in_proj_{rules}"]
        assert shape == (P, d // 2 if rules == "fsdp" else d, di2 // 2)
        np.testing.assert_array_equal(got, want)


def test_expert_f_split_matches_one_rank(grid):
    """The 2-D rules (``mlp`` over (model, data), ``batch`` whole): each
    rank runs its F block of its 4 of 8 experts and the combine sums over
    both axes. Output, aux, the input's and every leaf's gradient within
    1e-5 of the one-rank MoE."""
    from repro_torch.distributed.sharding import init_params, iter_leaves, map_tree
    from repro_torch.models import moe as moe_lib

    res, _ = grid
    cfg = _ep2d_cfg()
    p = map_tree(lambda t: t.requires_grad_(True), init_params(
        moe_lib.moe_defs(cfg), torch.Generator().manual_seed(5), "float32"))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 32, 32)).astype(np.float32)).requires_grad_(True)
    y, aux = moe_lib.moe_apply(p, x, cfg)
    w = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 32, 32)).astype(np.float32))
    ((y * w).sum() + aux).backward()
    for r in res:
        e = r["ep2d"]
        assert e["wg_block"] == (4, 32, 32)  # 4 of 8 experts, F 32 of 64
        np.testing.assert_allclose(e["y"], y.detach().numpy(), rtol=0,
                                   atol=1e-5 * y.abs().max().item())
        assert abs(e["aux"] - aux.item()) <= 1e-6
        np.testing.assert_allclose(e["dx"], x.grad.numpy(), rtol=0,
                                   atol=1e-5 * x.grad.abs().max().item())
        for k, t in iter_leaves(p):
            g = t.grad.numpy()
            assert T.rel_l2(e["grads"][k], g) <= 1e-5, k


def _one_rank_int8():
    from repro_torch.distributed.sharding import Runtime
    from repro_torch.models import build_model

    return _int8_step(Runtime(), build_model(_jamba_cfg()).param_defs())[0]


def _codes_equal(got: dict, want: dict) -> None:
    """Every moment's codes and row scales and every param as the one-rank
    step's: the scales within 1e-6, the params within 1e-6 or a few
    float32 steps, the codes equal but for a half-integer tie that the
    ranks' other summation order rounds the other way (at most one code,
    at a few elements)."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k.endswith("/q"):
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, k
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=STEP_ATOL,
                                       err_msg=k)


def test_int8_moments_row_scales_span_the_ranks(grid, model2):
    """int8 AdamW moments of jamba's smoke leaves whose last axis is split
    (wg/wu's mlp, in_proj's and dt_proj's conv_inner on (model 2); under
    FSDP also every embed-last leaf): the row absmax is the ranks' max, so
    codes and scales are the one-rank step's."""
    want = _one_rank_int8()
    for r in grid[0]:
        _codes_equal(r["int8_fsdp"], want)
    for r in model2:
        _codes_equal(r["int8_model"], want)


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-1.7b"])
def test_int8_kv_cache_matches_one_rank(model2, arch):
    """The int8 KV cache on (model 2): qwen3's rank holds its KV head's
    codes and row scales, gemma's rank its one KV head whole (k and v are
    gathered over head_dim before they are cached); both equal the
    one-rank cache's (the scales within 1e-5, the codes but for a
    half-integer tie), and the gathered prefill logits the one-rank's."""
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = T.family_cfg(arch).replace(kv_quant="int8")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits, cache = serve.prefill_cache(
            model, params, torch.from_numpy(T.prompts(cfg)), cache_len=16)
    for r in model2:
        got_logits, got = r[f"kv_{arch}"]
        np.testing.assert_allclose(got_logits, logits.numpy(), rtol=0,
                                   atol=1e-5 * logits.abs().max().item())
        for k, t in cache.items():
            w = t.numpy()
            if arch == "qwen3-1.7b" and k != "enc_len":
                w = w[:, :, :, r["rank"]:r["rank"] + 1]
            assert got[k].shape == w.shape, (k, got[k].shape, w.shape)
            if k.endswith("_scale"):
                np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=0)
            else:
                diff = np.abs(got[k].astype(np.int32) - w.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, k


def test_elastic_checkpoint_across_meshes(grid, model2):
    """An int8-moment state saved on (data 2, model 2) under FSDP_RULES is
    one step dir of whole leaves; restored on (model 2) each rank holds its
    blocks (in_proj's two runs, a moment's row scales), and gathered whole
    they equal the one-rank restore leaf for leaf; saved again from (model
    2), the one-rank restore of that step is the same."""
    from repro_torch.checkpoint.manager import CheckpointManager, _flatten

    _, ckpt = grid
    mgr = CheckpointManager(ckpt)
    assert mgr.validate(1) is None and mgr.validate(2) is None
    skel = {k: torch.from_numpy(np.zeros(m["shape"], dtype=np.float32))
            for k, m in mgr.manifest(1)["leaves"].items()}
    one = {k: v.numpy() for k, v in _flatten(mgr.restore(1, _nest(skel))).items()}
    again = {k: v.numpy() for k, v in
             _flatten(mgr.restore(2, _nest(skel))).items()}
    assert sorted(one) == sorted(again)
    assert mgr.manifest(1)["leaves"]["params.periods.pos0.mamba.in_proj"][
        "shape"] == list(one["params.periods.pos0.mamba.in_proj"].shape)
    for k, v in one.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
        for r in model2:
            np.testing.assert_array_equal(r["restored"][k], v, err_msg=k)


def _nest(flat: dict) -> dict:
    """A restore skeleton from manifest keys (``a.b.c``): nested dicts,
    an int8 moment's pair as a tuple."""
    out: dict = {}
    for key, t in flat.items():
        node = out
        *parents, name = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = t

    def tup(n):
        if isinstance(n, dict):
            if set(n) == {"0", "1"}:
                return (n["0"], n["1"])
            return {k: tup(v) for k, v in n.items()}
        return n
    return tup(out)
