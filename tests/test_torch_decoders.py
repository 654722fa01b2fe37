"""The port's remaining decoder configs against the JAX reference, on the
CPU: llama3-8b, gemma-2b, granite-8b (dense) and qwen3-moe-30b-a3b,
phi3.5-moe-42b-a6.6b (MoE), all through ``models.transformer.DenseLM``.

Each arch's smoke config (float32, 2 layers, d 128; the MoE ones with 4
experts, top-2). The reference makes the weights
(``model.init(jax.random.key(0))``) and they are carried across with
``repro_torch.bridge.params_from_numpy``. As in ``tests/test_torch_llava.py``,
prefill, decode and the loss are held to ``TOL`` on the same weights
rescaled to std 1/sqrt(input width) (the reference's fan-in rule draws a
layer-stacked weight with std 1/sqrt(layers)); greedy tokens are held equal
on the reference's own init. ``moe_apply`` is held at the published
expert counts (128 experts top-8, 16 top-2) at a narrow width, at a
decode step's 4 tokens (capacity 1) and a prefill's 1,024.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.distributed.sharding import Runtime  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import PORTED_ARCHS, get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.distributed.sharding import iter_leaves  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = dict(rtol=3e-4, atol=3e-4)  # tests/test_kernels.py TOL
B, P, GEN = 2, 8, 6
ARCHS = ("llama3-8b", "gemma-2b", "granite-8b", "qwen3-moe-30b-a3b",
         "phi3.5-moe-42b-a6.6b")
MOE_ARCHS = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")


def _batch(cfg, seed=0, labels=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(2, cfg.vocab_size, size=(B, P)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)
        out["labels"][:, -1] = -1
    return out


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _fan(path, d):
    """The input width a layer-stacked fan-in weight contracts: experts'
    (L, E, in, out) their third axis, the attention output projection
    heads x head_dim, the rest their second axis."""
    if "moe" in path:
        return d.shape[2]
    return d.shape[1] * (d.shape[2] if path[-1] == "wo" else 1)


def _conditioned(tree, defs, path=()):
    """The reference's weights with every layer-stacked fan-in weight
    rescaled from std 1/sqrt(layers) to 1/sqrt(input width)."""
    if isinstance(tree, dict):
        return {k: _conditioned(tree[k], defs[k], path + (k,)) for k in tree}
    if path[0] == "blocks" and defs.init == "fan_in":
        return (tree * np.sqrt(defs.shape[0] / _fan(path, defs))).astype(tree.dtype)
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """Each arch's reference model and weights (its own init, and that
    init conditioned), and the port's model on the same weights."""
    jcfg = jsmoke_config(jget_config(request.param))
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = build_model(smoke_config(get_config(request.param)))
    raw = jax.tree.map(np.asarray, jp)
    cond = _conditioned(raw, jm.param_defs())
    return dict(jcfg=jcfg, jm=jm, jp=jp, tm=tm,
                tp=params_from_numpy(raw, "cpu", defs=tm.param_defs()),
                jcond=jax.tree.map(jnp.asarray, cond),
                tcond=params_from_numpy(cond, "cpu", defs=tm.param_defs()))


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


# -- configs and parameters --------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Every field of the reference's, at the published size and the smoke
    size; the port's own ``embed_scale`` is set where the reference's name
    rule (``name.startswith("gemma")``) scales the embeddings."""
    assert arch in PORTED_ARCHS
    for full in (True, False):
        got, want = get_config(arch), jget_config(arch)
        if not full:
            got, want = smoke_config(got), jsmoke_config(want)
        for f in dataclasses.fields(want):
            assert getattr(got, f.name) == getattr(want, f.name), (arch, f.name)
        assert got.resolved_head_dim == want.resolved_head_dim
        assert got.embed_scale == want.name.startswith("gemma"), arch
    assert ({f.name for f in dataclasses.fields(ModelConfig)}
            - {f.name for f in dataclasses.fields(want)}) == {"embed_scale"}


def test_param_defs_and_bridge_match_reference(ref):
    """The same paths and shapes (experts and router, or the dense FFN;
    the tied or untied unembedding); the bridged tree equals the
    reference's leaf for leaf."""
    want = {"/".join(str(getattr(k, "key", k)) for k in p): a
            for p, a in jax.tree_util.tree_leaves_with_path(ref["jp"])}
    got = dict(iter_leaves(ref["tp"]))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[path]), path)
    cfg = ref["jcfg"]
    if cfg.num_experts:
        assert {"blocks/moe/router", "blocks/moe/wg", "blocks/moe/wu",
                "blocks/moe/wd"} <= set(got)
        assert got["blocks/moe/wg"].shape[1] == cfg.num_experts
    assert ("embed/unembed" in got) == (not cfg.tie_embeddings)


# -- gemma's embedding scale -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma_embed_tokens_matches_reference(dtype):
    """gemma's token embeddings are scaled by sqrt(d_model), the scale
    rounded to the compute dtype, bit for bit as the reference; a config
    without ``embed_scale`` is not scaled."""
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, size=(B, P)).astype(np.int32)
    tok = rng.normal(size=(512, 128)).astype(np.float32)
    for arch, scaled in (("gemma-2b", True), ("llama3-8b", False)):
        cfg = smoke_config(get_config(arch)).replace(compute_dtype=dtype)
        jcfg = jsmoke_config(jget_config(arch)).replace(compute_dtype=dtype)
        want = jL.embed_tokens({"tok": jnp.asarray(tok)}, jnp.asarray(tokens),
                               jcfg)
        got = tL.embed_tokens({"tok": torch.from_numpy(tok)},
                              torch.from_numpy(tokens), cfg)
        assert str(got.dtype).removeprefix("torch.") == dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
        plain = torch.from_numpy(tok)[torch.from_numpy(tokens).long()]
        assert torch.equal(got.float(), plain.to(got.dtype).float()) != scaled


# -- the decoder ---------------------------------------------------------------------

def test_prefill_cache_and_decode_steps_match_reference(ref):
    """Prefill logits and cache, then three decode steps' logits and the
    cache after each, within TOL on the conditioned weights."""
    jm, jp, tm, tp = ref["jm"], ref["jcond"], ref["tm"], ref["tcond"]
    batch = _batch(ref["jcfg"])
    jlogits, jcache = jm.prefill(jp, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        logits, cache = tm.prefill(tp, _tb(batch))
    _close(logits, jlogits, "prefill logits")
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == jcache[k].shape
        _close(cache[k], jcache[k], f"cache {k}")
    n = P + 3
    jc = jserve.pad_cache_to_defs(jcache, jserve.init_cache_concrete(jm, B, n),
                                  jm.cache_defs(B, n))
    tc = serve.pad_cache_to_defs(cache, tm.cache_defs(B, n), "float32")
    tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[:, None]
    for i in range(3):
        jstep, jc = jm.decode_step(jp, jc, jnp.asarray(tok), P + i)
        with torch.no_grad():
            step, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), P + i)
        _close(step, jstep, f"decode step {i} logits")
        for k in ("k", "v"):
            _close(tc[k], jc[k], f"cache {k} after step {i}")
        tok = np.asarray(jnp.argmax(jstep[:, -1], -1)).astype(np.int32)[:, None]


def test_greedy_tokens_match_reference(ref):
    """The serving loop on the reference's own init: the same greedy
    tokens as the reference's ``generate``."""
    prompts = _batch(ref["jcfg"], seed=3)["tokens"]
    want, _ = jserve.generate(ref["jm"], ref["jp"], jnp.asarray(prompts),
                              gen_len=GEN, cache_len=P + GEN)
    got, done = serve.generate(ref["tm"], ref["tp"], torch.from_numpy(prompts),
                               gen_len=GEN, cache_len=P + GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert done.shape == (B,)


def test_loss_and_every_grad_match_reference(ref):
    """The loss (with the MoE load-balancing term where there are experts)
    within 1e-5 and the gradient of every leaf, the router's among them,
    within TOL with atol taken times max(1, max |g|)
    (``tests/test_grads.py`` ``_close_scaled``)."""
    jm, tm = ref["jm"], ref["tm"]
    batch = _batch(ref["jcfg"], labels=True)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        ref["jcond"], jax.tree.map(jnp.asarray, batch))
    jgrads = dict(iter_leaves(jax.tree.map(np.asarray, jgrads)))
    loss, grads = tsteps.loss_and_grads(tm, ref["tcond"], _tb(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = dict(iter_leaves(grads))
    assert set(got) == set(jgrads)
    if ref["jcfg"].num_experts:
        assert "blocks/moe/router" in got
    for path, g in got.items():
        want = jgrads[path]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=TOL["rtol"],
            atol=TOL["atol"] * max(1.0, np.abs(want).max()), err_msg=path)
        assert np.abs(want).max() > 0, path


# -- the MoE FFN at the published expert counts ------------------------------------

def _kept(ids, n_exp, cap):
    """Which of the T*K copies keep their slot: the first ``cap`` of each
    expert in token order."""
    flat = ids.reshape(-1)
    seen = np.zeros(n_exp, np.int64)
    keep = np.zeros(flat.shape, bool)
    for i, e in enumerate(flat):
        keep[i] = seen[e] < cap
        seen[e] += 1
    return keep


@pytest.mark.parametrize("T", [4, 1024])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_at_published_expert_counts(arch, T):
    """``moe_apply`` with the published experts and top-k (128 top-8, 16
    top-2) at d 32 and an expert width of 16: the same expert ids, the
    same copies dropped by the capacity, the output and the auxiliary
    within TOL. At T = 4 (a decode step of B = 4) the capacity is 1."""
    full = get_config(arch)
    cfg = smoke_config(full).replace(
        d_model=32, d_ff=16, num_experts=full.num_experts,
        experts_per_token=full.experts_per_token)
    jcfg = jsmoke_config(jget_config(arch)).replace(
        d_model=32, d_ff=16, num_experts=full.num_experts,
        experts_per_token=full.experts_per_token)
    E, K, D, F = cfg.num_experts, cfg.experts_per_token, 32, 16
    rng = np.random.default_rng(11)
    p = {"router": rng.normal(size=(D, E)) / np.sqrt(D),
         "wg": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "wu": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "wd": rng.normal(size=(E, F, D)) / np.sqrt(F)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(4, T // 4, D)).astype(np.float32)
    xt = x.reshape(T, D)
    cap = int(max(1, T * K / E * cfg.capacity_factor))
    assert cap == {4: 1, 1024: 1024 * K // E * 5 // 4}[T]
    _, ids, _ = tmoe._route(torch.from_numpy(xt), torch.from_numpy(p["router"]), K)
    _, jids, _ = jmoe._route(jnp.asarray(xt), jnp.asarray(p["router"]), K)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    keep = _kept(ids.numpy(), E, cap)
    assert keep.sum() == np.minimum(
        np.bincount(ids.numpy().ravel(), minlength=E), cap).sum()
    if T == 1024:
        assert 0 < (~keep).sum()  # some copies drop at the published E, K
    want, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                jcfg, Runtime())
    got, aux = tmoe.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), cfg)
    _close(got, want, "moe output")
    _close(aux, jaux, "aux")
    # a dropped copy adds nothing: with only the kept copies' gated expert
    # outputs the output is the same
    probs = torch.softmax(torch.from_numpy(xt) @ torch.from_numpy(p["router"]), -1)
    g, _ = torch.topk(probs, K, dim=-1)
    g = (g / g.sum(-1, keepdim=True)).reshape(-1)[keep]
    tok = np.arange(T * K)[keep] // K
    e = ids.reshape(-1)[keep]
    h = torch.from_numpy(xt[tok])[:, None]
    w = {k: torch.from_numpy(v)[e] for k, v in p.items() if k != "router"}
    y = torch.bmm(tL.act_fn(cfg.activation)(torch.bmm(h, w["wg"]))
                  * torch.bmm(h, w["wu"]), w["wd"])[:, 0]
    out = torch.zeros((T, D)).index_add_(0, torch.from_numpy(tok), g[:, None] * y)
    _close(got.reshape(T, D), out, "kept copies only")


# -- the CLIs --------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["fp", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_prints_reference_key(arch, kv_quant, capsys):
    """The serve CLI on the smoke config, fp and ``--kv-quant int8``: it
    serves and prints the reference's ``attn_dec`` key."""
    extra = ["--kv-quant", "int8"] if kv_quant == "int8" else []
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "4", *extra])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out
    cfg = jsmoke_config(jget_config(arch))
    key = jautotune.attn_dec_key(
        2, 12, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
        cfg.resolved_head_dim, "int8" if kv_quant == "int8" else "float32")
    assert f"key={key} " in out


def test_train_cli_trains_moe(tmp_path, capsys):
    """The train CLI on qwen3-moe's smoke config: finite losses, the MoE
    auxiliary in them."""
    out = ttrain.main([
        "--arch", "qwen3-moe-30b-a3b", "--smoke", "--steps", "2", "--batch",
        "2", "--grad-accum", "1", "--seq", "32", "--device", "cpu",
        "--run-dir", str(tmp_path), "--log-every", "1",
    ])
    text = capsys.readouterr().out
    assert "[train] done; final loss" in text
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
