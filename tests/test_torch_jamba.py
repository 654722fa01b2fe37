"""The port's jamba serving slice against the JAX reference, on the CPU.

jamba-1.5-large-398b's smoke config (float32, one period of 8 layers: 7
Mamba blocks and one attention block, 4 experts top-2 on the odd
positions) at the serve CLI's request (B=2, P=16, 8 generated tokens). The
reference makes the weights (``model.init(jax.random.key(0))``) and, for
``--quant int8``, quantizes them for serving; both trees are carried across
with ``repro_torch.bridge.params_from_numpy``. The reference runs
``conv_backend="sliding_pallas"``, whose Pallas rungs demote here to its
plain depthwise conv (``core.conv.conv1d_depthwise_sliding``) and the
int8 ``qconv.conv1d_depthwise_q``; the port runs ``sliding_pallas`` too,
whose kernel wrappers run their plain versions on CPU tensors. The
reference's serving run is made once per module.

Numerics. The reference's init draws every period-stacked weight with std
1/sqrt(periods) = 1 here (the fan-in quirk, ROADMAP Queue 3), which makes
this model's float32 forward ill-conditioned: scaling the token embeddings
by (1 + 1e-7), a change of float rounding size, moves its prefill logits
by about 3e-4 of their largest value, and the reference's own float32
logits lie 6e-4 of it away from the same model evaluated in float64. On
these weights the port is held to equal greedy tokens in every mode and,
for the float logits, to three times the spread that such a rounding-size
change makes (measured on every run, and itself held under 2e-3). The
strict tolerance (``TOL``, ``tests/test_kernels.py``) is held on the same
weights rescaled to std 1/sqrt(input width), where the model is well
conditioned: logits, every cache leaf and a decode step. The int8 path
(``--quant int8 --kv-quant int8``) holds ``TOL`` on the reference's own
weights.
"""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.distributed.sharding import Runtime  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import PORTED_ARCHS, get_config, smoke_config  # noqa: E402
from repro_torch.distributed.sharding import ParamDef, iter_leaves  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ARCH = "jamba-1.5-large-398b"
TOL = dict(rtol=3e-4, atol=3e-4)  # tests/test_kernels.py TOL
B, P, GEN = 2, 16, 8  # the serve CLI's smoke request
CACHE_LEN = P + GEN


def _prompts(cfg, seed=0):
    """The serve CLIs' prompts: ``default_rng(seed)`` over the vocab."""
    rng = np.random.default_rng(seed)
    return rng.integers(2, cfg.vocab_size, size=(B, P)).astype(np.int32)


def _fan(path, d) -> int:
    """The input width of a period-stacked weight (the axis after the
    stack; experts and the attention output projection contract more)."""
    if "moe" in path:
        return d.shape[2]
    if path[-1] == "wo":
        return d.shape[1] * d.shape[2]
    return d.shape[1]


def _conditioned(tree, defs, path=()):
    """The reference's weights with every period-stacked fan-in weight
    divided by sqrt of its input width: a well-conditioned model."""
    if isinstance(tree, dict):
        return {k: _conditioned(tree[k], defs[k], path + (k,)) for k in tree}
    if path[0] == "periods" and defs.init == "fan_in":
        return tree / np.sqrt(_fan(path, defs))
    return tree


def _jserve_run(jm, jp, prompts):
    logits, cache = jserve.prefill_cache(jm, jp, jnp.asarray(prompts),
                                         cache_len=CACHE_LEN)
    toks, _ = jserve.generate(jm, jp, jnp.asarray(prompts), gen_len=GEN,
                              cache_len=CACHE_LEN)
    return (np.asarray(logits), jax.tree.map(np.asarray, cache),
            np.asarray(toks))


@pytest.fixture(scope="module")
def ref():
    """The reference's weights and serving runs, made once: fp,
    ``--kv-quant int8``, ``--quant int8 --kv-quant int8`` on its own
    weights, and fp on the conditioned weights."""
    jcfg = jsmoke_config(jget_config(ARCH)).replace(
        conv_backend="sliding_pallas")
    jops.ATTN_DECODE_DISPATCH.clear()  # keys are logged as decode traces
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    prompts = _prompts(jcfg)
    out = dict(jcfg=jcfg, jm=jm, jp=jp, prompts=prompts,
               np_params=jax.tree.map(np.asarray, jp))
    out["fp"] = _jserve_run(jm, jp, prompts)
    cond = _conditioned(out["np_params"], jm.param_defs())
    out["cond_params"] = cond
    out["cond"] = _jserve_run(jm, jax.tree.map(jnp.asarray, cond), prompts)
    jc = jax.tree.map(jnp.asarray, out["cond"][1])
    step, _ = jm.decode_step(jax.tree.map(jnp.asarray, cond), jc,
                             jnp.asarray(out["cond"][2][:, :1]), P)
    out["cond_step"] = np.asarray(step)
    jm8 = jbuild_model(jcfg.replace(kv_quant="int8"))
    out["kv8"] = _jserve_run(jm8, jp, prompts)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jcfg_q, jqp = jserve.quantize_for_serving(jm8, jp, jnp.asarray(prompts))
    out["quant_line"] = [ln for ln in buf.getvalue().splitlines()
                         if "--quant:" in ln]
    out["jqp"] = jax.tree.map(np.asarray, jqp)
    out["q8"] = _jserve_run(jbuild_model(jcfg_q), jqp, prompts)
    out["attn_keys"] = sorted(k for k, _ in jops.ATTN_DECODE_DISPATCH.items())
    out["cache_bytes"] = {
        kv: jserve.cache_nbytes(jbuild_model(jcfg.replace(kv_quant=kv))
                                .cache_defs(B, CACHE_LEN), jcfg.param_dtype)
        for kv in ("fp", "int8")}
    return out


def _port(kv_quant="fp", conv_precision="fp"):
    cfg = smoke_config(get_config(ARCH)).replace(
        conv_backend="sliding_pallas", kv_quant=kv_quant,
        conv_precision=conv_precision)
    return build_model(cfg)


def _params(tree, model):
    return params_from_numpy(tree, "cpu", defs=model.param_defs())


def _serve(model, params, prompts):
    logits, cache = serve.prefill_cache(model, params,
                                        torch.from_numpy(prompts),
                                        cache_len=CACHE_LEN)
    toks, _ = serve.generate(model, params, torch.from_numpy(prompts),
                             gen_len=GEN, cache_len=CACHE_LEN)
    return logits.numpy(), cache, toks.numpy()


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# -- configuration and parameters -----------------------------------------------

FIELDS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
          "vocab_size", "num_experts", "experts_per_token", "moe_every",
          "capacity_factor", "attn_every", "mamba_d_state", "mamba_conv_k",
          "mamba_expand", "rope_theta", "activation", "param_dtype",
          "mamba_d_inner", "resolved_dt_rank", "resolved_head_dim")


def test_config_and_defs_match_reference(ref):
    assert ARCH in PORTED_ARCHS
    for cfg, jcfg in ((get_config(ARCH), jget_config(ARCH)),
                      (smoke_config(get_config(ARCH)), ref["jcfg"])):
        assert [getattr(cfg, f) for f in FIELDS] == [getattr(jcfg, f)
                                                      for f in FIELDS]
    flat = lambda t: {p: (d.shape, d.axes, d.dtype, d.init)  # noqa: E731
                      for p, d in iter_leaves(t)}
    assert flat(_port().param_defs()) == flat(ref["jm"].param_defs())
    for kv in ("fp", "int8"):
        jd = jbuild_model(ref["jcfg"].replace(kv_quant=kv)).cache_defs(B, 24)
        assert flat(_port(kv_quant=kv).cache_defs(B, 24)) == flat(jd)


def test_full_width_cut_config_counts_its_params():
    """The configuration served at full width on the card: one period (8
    layers), no experts, every width the published one. Counted from the
    defs, nothing allocated."""
    cfg = get_config(ARCH).replace(num_layers=8, num_experts=0)
    n = sum(int(np.prod(d.shape)) for _, d in iter_leaves(
        build_model(cfg).param_defs()) if isinstance(d, ParamDef))
    assert n == 8_999_034_880
    jcfg = jget_config(ARCH).replace(num_layers=8, num_experts=0)
    jn = sum(int(np.prod(d.shape)) for d in jax.tree.leaves(
        jbuild_model(jcfg).param_defs(), is_leaf=lambda x: hasattr(x, "axes")))
    assert jn == n
    assert (cfg.d_model, cfg.mamba_d_inner, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.mamba_d_state, cfg.mamba_conv_k,
            cfg.resolved_dt_rank, cfg.vocab_size, cfg.d_ff) == (
        8192, 16384, 64, 8, 128, 16, 4, 512, 65536, 24576)


def test_smoke_logits_are_not_all_zero(ref):
    """The parity below is not vacuous: the smoke model does not collapse
    as the full-width random one does."""
    for mode in ("fp", "cond", "q8"):
        logits = ref[mode][0]
        assert np.isfinite(logits).all() and np.abs(logits).max() > 0.1, mode
        assert len(np.unique(ref[mode][2])) > 4, mode


# -- layers ------------------------------------------------------------------------

def test_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    pos = np.arange(9)[None, :] + np.array([[0], [283]])
    want = np.asarray(jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    got = tL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tL.rope_freqs(32, 1e4).numpy(),
                               np.asarray(jL.rope_freqs(32, 1e4)), rtol=1e-6)


def test_gated_mlp_matches_reference(ref):
    cfg = smoke_config(get_config(ARCH))
    lp = {k: v[0] for k, v in ref["cond_params"]["periods"]["pos0"]["mlp"].items()}
    assert set(tL.mlp_defs(cfg)) == {"wg", "wu", "wd"}
    x = np.random.default_rng(1).normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    want = np.asarray(jL.mlp_apply(jax.tree.map(jnp.asarray, lp),
                                   jnp.asarray(x), ref["jcfg"]))
    got = tL.mlp_apply({k: torch.from_numpy(v) for k, v in lp.items()},
                       torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_routes_and_drops_as_reference(ref, capacity_factor):
    """The same expert ids, and at a capacity factor of 0.5 (capacity 8 of
    the 16 copies an expert gets on average) the same tokens drop: a token
    dropped on one side and kept on the other would move its output by the
    expert's whole contribution."""
    cfg = smoke_config(get_config(ARCH)).replace(capacity_factor=capacity_factor)
    jcfg = ref["jcfg"].replace(capacity_factor=capacity_factor)
    lp = {k: np.array(v[0]) for k, v in
          ref["cond_params"]["periods"]["pos1"]["moe"].items()}
    x = np.random.default_rng(2).normal(size=(B, P, cfg.d_model)).astype(np.float32)
    xt = x.reshape(-1, cfg.d_model)
    _, ids, _ = tmoe._route(torch.from_numpy(xt), torch.from_numpy(lp["router"]),
                            cfg.experts_per_token)
    _, jids, _ = jmoe._route(jnp.asarray(xt), jnp.asarray(lp["router"]),
                             cfg.experts_per_token)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    cap = int(max(1, xt.shape[0] * cfg.experts_per_token / cfg.num_experts
                  * capacity_factor))
    overflow = np.bincount(ids.numpy().ravel(), minlength=cfg.num_experts) > cap
    assert overflow.any() == (capacity_factor < 1)
    want, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, lp), jnp.asarray(x),
                                jcfg, Runtime())
    got, aux = tmoe.moe_apply({k: torch.from_numpy(v) for k, v in lp.items()},
                              torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_mamba_apply_prefill_and_decode_step_match_reference(ref):
    """One Mamba block on the reference's own weights: the prefill output
    and final {conv, ssm} state, then one decode step from that state."""
    cfg = smoke_config(get_config(ARCH)).replace(conv_backend="sliding_pallas")
    rt = Runtime()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    for j in (0, 5):
        lp = {k: np.array(v[0]) for k, v in
              ref["np_params"]["periods"][f"pos{j}"]["mamba"].items()}
        jlp = jax.tree.map(jnp.asarray, lp)
        tlp = {k: torch.from_numpy(v) for k, v in lp.items()}
        jy, jst = jmamba.mamba_apply(jlp, jnp.asarray(x), ref["jcfg"], rt,
                                     return_state=True)
        ty, tst = tmamba.mamba_apply(tlp, torch.from_numpy(x), cfg,
                                     return_state=True)
        scale = lambda a: dict(rtol=TOL["rtol"],  # noqa: E731
                               atol=TOL["atol"] * max(1.0, np.abs(a).max()))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **scale(jy))
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                       **scale(np.asarray(jst[name])))
        jy1, jst1 = jmamba.mamba_apply(jlp, jnp.asarray(x1), ref["jcfg"], rt,
                                       state=jst)
        ty1, tst1 = tmamba.mamba_apply(tlp, torch.from_numpy(x1), cfg,
                                       state={k: torch.from_numpy(np.array(v))
                                              for k, v in jst.items()})
        np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), **scale(jy1))
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(tst1[name].numpy(), np.asarray(jst1[name]),
                                       **scale(np.asarray(jst1[name])))


def test_assoc_scan_is_the_reference_recursion():
    """The chunk scan combines the same pairs in the same order as
    ``jax.lax.associative_scan``: equal to the last bit, odd and even
    lengths."""
    rng = np.random.default_rng(4)
    for n in (1, 2, 7, 16, 33):
        a = rng.uniform(0.3, 1.0, size=(2, n, 8, 4)).astype(np.float32)
        b = (rng.normal(size=(2, n, 8, 4)) * 1e3).astype(np.float32)
        h0 = rng.normal(size=(2, 8, 4)).astype(np.float32)
        jh, jl = jmamba._assoc_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
        th, tl = tmamba._assoc_scan(torch.from_numpy(a), torch.from_numpy(b),
                                    torch.from_numpy(h0))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_kv_prefix_views_match_reference():
    leaves = {"attn_k": np.ones(2), "attn_k_scale": np.ones(1),
              "attn_v": np.zeros(2), "mamba0": {"conv": np.ones(3)}}
    want = jcommon.strip_kv_prefix(leaves, "attn_")
    got = tcommon.strip_kv_prefix(leaves, "attn_")
    assert got.keys() == want.keys() == {"k", "k_scale", "v"}
    assert tcommon.add_kv_prefix(got, "attn_").keys() == \
        jcommon.add_kv_prefix(want, "attn_").keys()


# -- the model -----------------------------------------------------------------------

def test_prefill_cache_and_decode_step_match_reference_conditioned(ref):
    """On the well-conditioned weights: prefill logits, every cache leaf
    (attention K/V padded to the cache, the mamba states unpadded) and one
    decode step's logits within TOL; greedy tokens equal."""
    tm = _port()
    tp = _params(ref["cond_params"], tm)
    logits, cache, toks = _serve(tm, tp, ref["prompts"])
    jlogits, jcache, jtoks = ref["cond"]
    np.testing.assert_allclose(logits, jlogits, **TOL)
    np.testing.assert_array_equal(toks, jtoks)
    got = dict(iter_leaves(cache))
    assert set(got) == {p for p, _ in iter_leaves(jcache)}
    for path, t in got.items():
        want = _leaf(jcache, path)
        assert tuple(t.shape) == want.shape, path
        atol = TOL["atol"] * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(t.float().numpy(), want, rtol=TOL["rtol"],
                                   atol=atol, err_msg=path)
    assert cache["attn_k"].shape[2] == CACHE_LEN
    assert cache["mamba0"]["ssm"].dtype == torch.float32
    step, _ = tm.decode_step(tp, cache, torch.from_numpy(jtoks[:, :1]), P)
    np.testing.assert_allclose(step.numpy(), ref["cond_step"], **TOL)


def _spread(tm, tp, prompts, eps=1e-7):
    """How far the port's prefill logits move when the token embeddings are
    scaled by (1 + eps): the float32 rounding noise this model amplifies,
    as a share of max |logit|."""
    batch = {"tokens": torch.from_numpy(prompts)}
    with torch.no_grad():
        base = tm.prefill(tp, batch)[0]
        nudged = dict(tp, embed={k: v * (1 + eps) for k, v in tp["embed"].items()})
        moved = tm.prefill(nudged, batch)[0]
    return float((moved - base).abs().max() / base.abs().max())


@pytest.mark.parametrize("mode", ["fp", "kv8", "q8"])
def test_greedy_tokens_and_prefill_logits_match_reference(ref, mode):
    """The CLI's request on the reference's own weights, in the three modes
    (``--kv-quant int8``; ``--quant int8 --kv-quant int8``): greedy tokens
    equal; int8 prefill logits within TOL; float prefill logits within
    three times the spread float32 rounding makes (module docstring)."""
    if mode == "q8":
        tm = _port(kv_quant="int8", conv_precision="w8a8")
        tp = _params(ref["jqp"], tm)
    else:
        tm = _port(kv_quant="int8" if mode == "kv8" else "fp")
        tp = _params(ref["np_params"], tm)
    logits, cache, toks = _serve(tm, tp, ref["prompts"])
    jlogits, jcache, jtoks = ref[mode]
    np.testing.assert_array_equal(toks, jtoks)
    if mode == "q8":
        np.testing.assert_allclose(logits, jlogits, **TOL)
    else:
        spread = _spread(tm, tp, ref["prompts"])
        assert spread < 2e-3
        rel = np.abs(logits - jlogits).max() / np.abs(jlogits).max()
        assert rel <= max(TOL["rtol"], 3 * spread), (rel, spread)
    if mode != "fp":
        assert cache["attn_k"].dtype == torch.int8
        assert cache["attn_k_scale"].dtype == torch.float32
        assert cache["mamba1"]["ssm"].dtype == torch.float32


def test_quantize_for_serving_matches_reference(ref, capsys):
    """The port's own ``--quant int8`` on the reference's float weights: the
    seven ``conv_w`` leaves int8 with per-channel scales (periods, 1, C),
    equal to the reference's, and no calibrated site: the mamba convs take
    a dynamic activation scale, as in the reference."""
    tm = _port(kv_quant="int8")
    tp = _params(ref["np_params"], tm)
    cfg_q, tqp = serve.quantize_for_serving(tm, tp, torch.from_numpy(ref["prompts"]))
    out = capsys.readouterr().out
    line = "--quant: 7 conv weight(s) int8, 0 calibrated site(s), 0 chained"
    assert f"[serve] {line}" in out
    assert any(line in ln for ln in ref["quant_line"])
    assert cfg_q.conv_precision == "w8a8" and quant.quantized_site_count(tqp) == 7
    for j in (0, 1, 2, 3, 5, 6, 7):
        got = tqp["periods"][f"pos{j}"]["mamba"]["conv_w"]
        want = ref["jqp"]["periods"][f"pos{j}"]["mamba"]["conv_w"]
        assert got.scale.shape == (1, 1, tm.cfg.mamba_d_inner)
        assert got.x_scale is None and want.x_scale is None
        np.testing.assert_array_equal(got.q.numpy(), want.q)
        np.testing.assert_array_equal(got.scale.numpy(), want.scale)
    # the bridge carries the reference's quantized leaves with their shapes
    bq = _params(ref["jqp"], tm)["periods"]["pos0"]["mamba"]["conv_w"]
    assert isinstance(bq, quant.QuantizedWeight) and bq.scale.shape == (1, 1, 256)


def test_cache_padding_walks_the_mamba_states(ref):
    """``pad_cache_to_defs`` and ``quantize_cache_to_defs`` on jamba's
    nested cache: attention K/V padded to the cache length (int8 with its
    scales), mamba states passed through unpadded, conv state in the param
    dtype, ssm state float32."""
    tm = _port(kv_quant="int8")
    tp = _params(ref["np_params"], tm)
    with torch.no_grad():
        _, raw = tm.prefill(tp, {"tokens": torch.from_numpy(ref["prompts"])})
    defs = tm.cache_defs(B, CACHE_LEN)
    q = serve.quantize_cache_to_defs(raw, defs)
    padded = serve.pad_cache_to_defs(q, defs, torch.bfloat16)
    for path, d in iter_leaves(defs):
        t = _leaf(padded, path)
        assert tuple(t.shape) == d.shape, path
    assert padded["attn_k"].dtype == torch.int8
    assert padded["mamba2"]["conv"].dtype == torch.bfloat16
    assert padded["mamba2"]["ssm"].dtype == torch.float32
    np.testing.assert_array_equal(padded["mamba2"]["ssm"].numpy(),
                                  raw["mamba2"]["ssm"].numpy())
    assert not padded["attn_k"][:, :, P:].any()


@pytest.mark.parametrize("flags,kv", [([], "fp"), (["--kv-quant", "int8"], "int8"),
                                      (["--quant", "int8", "--kv-quant", "int8"],
                                       "int8")])
def test_cli_lines_match_reference(ref, capsys, flags, kv):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", str(B),
                "--prompt-len", str(P), "--gen", str(GEN), "--conv-backend",
                "sliding_pallas", *flags])
    out = capsys.readouterr().out
    nbytes, fp = ref["cache_bytes"][kv], ref["cache_bytes"]["fp"]
    assert (f"[serve] kv-cache bytes: {nbytes} (fp {fp}, ratio "
            f"{fp / nbytes:.2f}x)") in out
    assert nbytes == (182272 if kv == "fp" else 164608)
    key = next(k for k in ref["attn_keys"] if k.endswith(
        "int8" if kv == "int8" else "float32"))
    assert f"key={key} " in out
    if "--quant" in flags:
        assert ("--quant: 7 conv weight(s) int8, 0 calibrated site(s), "
                "0 chained") in out
