"""The port's rwkv6-1.6b against the JAX reference, on the CPU.

The smoke config (float32, 2 layers, d 128, 4 heads of 32, chunk 128).
The reference makes the weights (``model.init(jax.random.key(0))``) and
``repro_torch.bridge.params_from_numpy`` carries them across. As in
``tests/test_torch_decoders.py``, the WKV evaluations, the two mixes,
prefill, decode and the loss are held to ``TOL`` on those weights with
every layer-stacked fan-in weight rescaled to std 1/sqrt(input width);
greedy tokens are held equal on the reference's own init.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.distributed.sharding import Runtime  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import PORTED_ARCHS, get_config, smoke_config  # noqa: E402
from repro_torch.distributed.sharding import iter_leaves  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402

TOL = dict(rtol=3e-4, atol=3e-4)  # tests/test_kernels.py TOL
ARCH = "rwkv6-1.6b"
B, P, GEN = 2, 16, 6


def _batch(cfg, seed=0, labels=False, length=P):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(2, cfg.vocab_size,
                                  size=(B, length)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size,
                                     size=(B, length)).astype(np.int32)
        out["labels"][:, -1] = -1
    return out


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _conditioned(tree, defs, path=()):
    """The reference's weights with every layer-stacked fan-in weight
    rescaled from std 1/sqrt(layers) to 1/sqrt(input width)."""
    if isinstance(tree, dict):
        return {k: _conditioned(tree[k], defs[k], path + (k,)) for k in tree}
    if path[0] == "blocks" and defs.init == "fan_in":
        return (tree * np.sqrt(defs.shape[0] / defs.shape[1])).astype(tree.dtype)
    return tree


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=what)


@pytest.fixture(scope="module")
def ref():
    """The reference model and weights (its own init, and that init
    conditioned) and the port's model on the same weights."""
    jcfg = jsmoke_config(jget_config(ARCH))
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = build_model(smoke_config(get_config(ARCH)))
    raw = jax.tree.map(np.asarray, jp)
    cond = _conditioned(raw, jm.param_defs())
    return dict(jcfg=jcfg, jm=jm, jp=jp, tm=tm,
                tp=params_from_numpy(raw, "cpu", defs=tm.param_defs()),
                jcond=jax.tree.map(jnp.asarray, cond),
                tcond=params_from_numpy(cond, "cpu", defs=tm.param_defs()))


# -- config, parameters, registry ------------------------------------------------

def test_config_matches_reference():
    """Every field of the reference's config, at the published size and
    the smoke size; the registry now holds every arch of the
    reference's."""
    assert ARCH in PORTED_ARCHS
    assert set(PORTED_ARCHS) == set(jbase.ARCH_IDS)
    for full in (True, False):
        got, want = get_config(ARCH), jget_config(ARCH)
        if not full:
            got, want = smoke_config(got), jsmoke_config(want)
        for f in dataclasses.fields(want):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.embed_scale is False
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.d_ff, full.vocab_size,
            full.rwkv_head_dim, full.activation, full.rwkv_wkv_mode,
            full.rwkv_wkv_chunk) == (24, 2048, 7168, 65_536, 64, "relu_sq",
                                     "chunked", 128)


def test_build_model_takes_the_configs_wkv_mode():
    m = build_model(smoke_config(get_config(ARCH)))
    assert isinstance(m, trwkv.RWKV6) and m.wkv_mode == "chunked"
    m = build_model(smoke_config(get_config(ARCH)).replace(rwkv_wkv_mode="scan"))
    assert m.wkv_mode == "scan"


def test_param_defs_and_bridge_match_reference(ref):
    """The same paths and shapes; the bridged tree equals the reference's
    leaf for leaf; the published config has 1.6 B parameters."""
    want = {"/".join(str(getattr(k, "key", k)) for k in p): a
            for p, a in jax.tree_util.tree_leaves_with_path(ref["jp"])}
    got = dict(iter_leaves(ref["tp"]))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[path]), path)
    full = build_model(get_config(ARCH)).param_defs()
    n = sum(int(np.prod(d.shape)) for _, d in iter_leaves(full))
    jfull = jbuild_model(jget_config(ARCH)).param_defs()
    jn = sum(int(np.prod(d.shape)) for d in jax.tree.leaves(
        jfull, is_leaf=lambda x: hasattr(x, "init")))
    assert n == jn and 1.5e9 < n < 1.7e9


def test_scan_blocks_collect_stacks_per_layer_states():
    """``collect=True`` returns (carry, the bodies' aux trees stacked per
    layer); without it, the carry alone, as before."""
    stacked = {"a": torch.arange(6.0).reshape(3, 2)}

    def body(x, lp):
        return x + lp["a"], {"s": x * 2, "n": {"t": lp["a"][:1]}}

    x, aux = common.scan_blocks(torch.zeros(2), stacked, body, remat=False,
                                collect=True)
    assert torch.equal(x, torch.tensor([6.0, 9.0]))
    assert torch.equal(aux["s"], torch.tensor([[0.0, 0], [0, 2], [4, 8]]))
    assert torch.equal(aux["n"]["t"], torch.tensor([[0.0], [2], [4]]))
    y = common.scan_blocks(torch.zeros(2), stacked,
                           lambda x, lp: x + lp["a"], remat=False)
    assert torch.equal(y, x)


# -- the WKV evaluations and the mixes --------------------------------------------

def _wkv_inputs(seed, L, H=4, K=32):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, L, H, K)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(np.clip(rng.normal(size=(B, L, H, K)), -10, 4)
                   ).astype(np.float32)
    u = (0.1 * rng.normal(size=(H, K))).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(B, H, K, K))).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("L,chunk", [(1, 32), (24, 32), (64, 32), (96, 32),
                                     (128, 128)])
def test_wkv_scan_and_chunked_match_reference(L, chunk):
    """Both evaluations against the reference's, from a nonzero state, and
    against each other: outputs and the final state."""
    arrs = _wkv_inputs(L, L)
    jarrs = [jnp.asarray(a) for a in arrs]
    tarrs = [torch.from_numpy(a) for a in arrs]
    jo_s, jS_s = jrwkv.wkv_scan(*jarrs)
    jo_c, jS_c = jrwkv.wkv_chunked(*jarrs, chunk=chunk)
    o_s, S_s = trwkv.wkv_scan(*tarrs)
    o_c, S_c = trwkv.wkv_chunked(*tarrs, chunk=chunk)
    for got, want, what in ((o_s, jo_s, "scan out"), (S_s, jS_s, "scan state"),
                            (o_c, jo_c, "chunked out"),
                            (S_c, jS_c, "chunked state"),
                            (o_c, o_s, "chunked vs scan out"),
                            (S_c, S_s, "chunked vs scan state")):
        assert got.dtype == torch.float32
        _close(got, want, what)


@pytest.mark.parametrize("L", [40, 200])
def test_ragged_prompt_raises(ref, L):
    """A sequence longer than the chunk and not a whole number of chunks:
    the reference fails in its reshape or an einsum, the port raises naming
    the constraint, in ``wkv_chunked`` and through the model's prefill."""
    arrs = _wkv_inputs(0, L)
    with pytest.raises((TypeError, ValueError)):
        jrwkv.wkv_chunked(*[jnp.asarray(a) for a in arrs], chunk=32)
    with pytest.raises(ValueError, match="whole number of 32-position chunks"):
        trwkv.wkv_chunked(*[torch.from_numpy(a) for a in arrs], chunk=32)
    if L > ref["jcfg"].rwkv_wkv_chunk:
        batch = _batch(ref["jcfg"], length=L)
        with pytest.raises((TypeError, ValueError)):
            ref["jm"].prefill(ref["jcond"], jax.tree.map(jnp.asarray, batch))
        with torch.no_grad(), pytest.raises(ValueError, match="whole number"):
            ref["tm"].prefill(ref["tcond"], _tb(batch))


def _layer0(ref):
    jlp = jax.tree.map(lambda a: a[0], ref["jcond"]["blocks"])
    tlp = common.layer(ref["tcond"]["blocks"], 0)
    return jlp, tlp


@pytest.mark.parametrize("mode", ["scan", "chunked"])
@pytest.mark.parametrize("carry", [False, True])
def test_time_mix_and_channel_mix_match_reference(ref, mode, carry):
    """One layer's time mix (output and state, from a nonzero state) and
    channel mix, with and without the token-shift carries."""
    jlp, tlp = _layer0(ref)
    cfg, jcfg = ref["tm"].cfg, ref["jcfg"]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
    H, K = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    s0 = (0.1 * rng.normal(size=(B, H, K, K))).astype(np.float32)
    prev = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32) if carry else None
    jprev = None if prev is None else jnp.asarray(prev)
    tprev = None if prev is None else torch.from_numpy(prev)
    jy, jS = jrwkv.time_mix(jlp, jnp.asarray(x), jcfg, Runtime(),
                            jnp.asarray(s0), x_prev=jprev, wkv_mode=mode)
    y, S = trwkv.time_mix(tlp, torch.from_numpy(x), cfg, torch.from_numpy(s0),
                          x_prev=tprev, wkv_mode=mode)
    _close(y, jy, "time mix")
    _close(S, jS, "time mix state")
    jc = jrwkv.channel_mix(jlp, jnp.asarray(x), jcfg, x_prev=jprev)
    c = trwkv.channel_mix(tlp, torch.from_numpy(x), cfg, x_prev=tprev)
    _close(c, jc, "channel mix")


# -- serving -----------------------------------------------------------------------

def test_prefill_cache_and_decode_steps_match_reference(ref):
    """Prefill logits and every cache leaf, then three decode steps'
    logits and every cache leaf after each, within TOL on the conditioned
    weights."""
    jm, jp, tm, tp = ref["jm"], ref["jcond"], ref["tm"], ref["tcond"]
    batch = _batch(ref["jcfg"])
    jlogits, jcache = jm.prefill(jp, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        logits, cache = tm.prefill(tp, _tb(batch))
    _close(logits, jlogits, "prefill logits")
    assert set(cache) == set(jcache) == {"wkv", "tm_prev", "cm_prev"}
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape, k
        _close(cache[k], jcache[k], f"cache {k}")
    n = P + 3
    jc = jserve.pad_cache_to_defs(jcache, jserve.init_cache_concrete(jm, B, n),
                                  jm.cache_defs(B, n))
    tc = serve.pad_cache_to_defs(cache, tm.cache_defs(B, n), "float32")
    assert tc["wkv"].dtype == torch.float32
    tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[:, None]
    for i in range(3):
        jstep, jc = jm.decode_step(jp, jc, jnp.asarray(tok), P + i)
        with torch.no_grad():
            step, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), P + i)
        _close(step, jstep, f"decode step {i} logits")
        for k in tc:
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
    """The loss within 1e-5 and the gradient of every leaf within TOL with
    atol taken times max(1, max |g|) (``tests/test_grads.py``
    ``_close_scaled``), at 256 positions: two whole chunks, each under its
    checkpoint."""
    jm, tm = ref["jm"], ref["tm"]
    batch = _batch(ref["jcfg"], labels=True, length=256)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        ref["jcond"], jax.tree.map(jnp.asarray, batch))
    jgrads = dict(iter_leaves(jax.tree.map(np.asarray, jgrads)))
    loss, grads = tsteps.loss_and_grads(tm, ref["tcond"], _tb(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = dict(iter_leaves(grads))
    assert set(got) == set(jgrads)
    for path, g in got.items():
        want = jgrads[path]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=TOL["rtol"],
            atol=TOL["atol"] * max(1.0, np.abs(want).max()), err_msg=path)


# -- the CLIs -------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_serve_cli(quant, capsys):
    """``--arch rwkv6-1.6b --smoke``, fp and ``--quant int8 --kv-quant
    int8``: the int8 run prints the reference's "no conv sites" line, and
    the recurrent cache has no int8 leaves (ratio 1.00x)."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen", "4"]
    if quant:
        argv += ["--quant", "int8", "--kv-quant", "int8"]
    serve.main(argv)
    out = capsys.readouterr().out
    assert "[serve] generated (2, 4) x1" in out
    assert ("[serve] --quant: rwkv6-1.6b has no conv sites; unchanged"
            in out) == quant
    assert "ratio 1.00x" in out


def test_train_cli(tmp_path, capsys):
    """``--arch rwkv6-1.6b --smoke --steps 3``: finite losses."""
    out = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "128",
                       "--run-dir", str(tmp_path)])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert "[train] done; final loss" in capsys.readouterr().out
