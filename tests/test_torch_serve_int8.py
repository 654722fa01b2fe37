"""The port's int8 serving slice against the JAX reference, on the CPU.

whisper-medium's smoke config (float32) with the CI command's int8 flags
(``--quant int8 --kv-quant int8``, B=2, P=16, gen 8). The reference makes
the weights (``model.init(jax.random.key(0))``) and quantizes them for
serving (``quantize_for_serving``: calibration prefill, requant chain,
int8 leaves); both trees are carried across with
``repro_torch.bridge.params_from_numpy``. The reference runs
``conv_backend="sliding"``, whose quantized conv sums int8 products in
float32: exact at this size (below 2**24), as the port's exact int32 sums
are. The port runs ``sliding_pallas``, whose kernels run their plain
versions on CPU tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.quant import qconv as jq  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.health import HEALTH  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402

TOL = dict(rtol=3e-4, atol=3e-4)  # tests/test_kernels.py TOL
B, P, GEN = 2, 16, 8  # the CI command's request
CACHE_LEN = P + GEN


def _prompts(cfg, seed=0):
    """The serve CLIs' prompts: ``default_rng(seed)`` over the vocab."""
    rng = np.random.default_rng(seed)
    return rng.integers(2, cfg.vocab_size, size=(B, P)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    jcfg = jsmoke_config(jget_config("whisper-medium")).replace(
        conv_backend="sliding", kv_quant="int8")
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    prompts = _prompts(jcfg)
    jcfg_q, jqp = jserve.quantize_for_serving(jm, jp, jnp.asarray(prompts))
    jmq = jbuild_model(jcfg_q)
    cfg = smoke_config(get_config("whisper-medium")).replace(
        conv_backend="sliding_pallas", kv_quant="int8")
    tm = build_model(cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           defs=tm.param_defs())
    tqp = params_from_numpy(jax.tree.map(np.asarray, jqp), "cpu",
                            defs=tm.param_defs())
    tmq = build_model(cfg.replace(conv_precision="w8a8"))
    return dict(jm=jm, jp=jp, jmq=jmq, jqp=jqp, tm=tm, tp=tp, tmq=tmq,
                tqp=tqp, prompts=prompts)


def test_bridge_carries_the_quantized_tree(pair):
    tqp, jqp = pair["tqp"], pair["jqp"]
    assert quant.quantized_site_count(tqp) == 2
    for key in ("conv1_w", "conv2_w"):
        got, want = tqp["frontend"][key], jqp["frontend"][key]
        assert isinstance(got, quant.QuantizedWeight)
        assert got.q.dtype == torch.int8 and got.x_scale.shape == ()
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert tqp["frontend"]["conv1_w"].out_scale is not None
    assert tqp["frontend"]["conv2_w"].out_scale is None
    bad = jax.tree.map(np.asarray, jqp)
    leaf = bad["frontend"]["conv2_w"]
    bad["frontend"]["conv2_w"] = leaf._replace(q=leaf.q.astype(np.int16))
    with pytest.raises(ValueError, match="not int8"):
        params_from_numpy(bad, "cpu")
    bad["frontend"]["conv2_w"] = leaf._replace(q=leaf.q[:2])
    with pytest.raises(ValueError, match="shape mismatch"):
        params_from_numpy(bad, "cpu", defs=pair["tm"].param_defs())


def test_calibration_for_serving_matches_reference(pair, capsys):
    """The port's own calibration prefill on the reference's float weights:
    the same int8 weight codes and scales, and activation scales within
    1e-6 (conv2's input is conv1's float output, summed in another
    order)."""
    cfg_q, tqp = serve.quantize_for_serving(
        pair["tm"], pair["tp"], torch.from_numpy(pair["prompts"]))
    assert cfg_q.conv_precision == "w8a8"
    assert ("[serve] --quant: 2 conv weight(s) int8, 2 calibrated site(s), "
            "1 chained") in capsys.readouterr().out
    for key in ("conv1_w", "conv2_w"):
        got, want = tqp["frontend"][key], pair["jqp"]["frontend"][key]
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
        for name in ("x_scale", "out_scale"):
            w = getattr(want, name)
            g = getattr(got, name)
            assert (g is None) == (w is None), name
            if w is not None:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_frontend_chain_has_one_dequant_site_and_equal_codes(pair):
    rng = np.random.default_rng(3)
    mels = rng.normal(size=(B, 2 * P, 80)).astype(np.float32)
    tf, jf = pair["tqp"]["frontend"], pair["jqp"]["frontend"]
    with quant.counting_dequants() as sites:
        enc = pair["tmq"].encode(pair["tqp"], torch.from_numpy(mels))
    assert sites == ["whisper/conv2"]
    want = np.asarray(pair["jmq"].encode(pair["jqp"], jnp.asarray(mels)))
    np.testing.assert_allclose(enc.numpy(), want, **TOL)
    # conv1 emits int8 codes on conv2's grid
    codes = tL.conv1d_bias_act(
        torch.from_numpy(mels), tf["conv1_w"], tf["conv1_b"],
        activation="gelu", padding="SAME", backend="sliding_pallas",
        precision="w8a8", site="whisper/conv1")
    jcodes = np.asarray(jL.conv1d_bias_act(
        jnp.asarray(mels), jf["conv1_w"], jf["conv1_b"], activation="gelu",
        padding="SAME", backend="sliding", precision="w8a8",
        site="whisper/conv1"))
    assert codes.dtype == torch.int8 and jcodes.dtype == np.int8
    qw = jf["conv1_w"]
    pre = np.asarray(jq.conv1d_q(
        jnp.asarray(mels), jq.QuantizedWeight(qw.q, qw.scale, qw.x_scale),
        jf["conv1_b"], padding="SAME", activation="gelu",
        accumulate="int32")) / np.asarray(qw.out_scale)
    diff = np.abs(codes.numpy().astype(np.int32) - jcodes)
    near_tie = np.abs(np.abs(pre - np.floor(pre)) - 0.5) < 1e-3
    assert diff.max() <= 1 and (near_tie | (diff == 0)).all()


def test_prefill_logits_and_int8_cache_match_reference(pair):
    prompts = pair["prompts"]
    jlogits, jcache = jserve.prefill_cache(
        pair["jmq"], pair["jqp"], jnp.asarray(prompts), cache_len=CACHE_LEN)
    logits, cache = serve.prefill_cache(
        pair["tmq"], pair["tqp"], torch.from_numpy(prompts),
        cache_len=CACHE_LEN)
    jl = np.asarray(jlogits)
    err = np.abs(logits.numpy() - jl).max()
    assert err <= 3e-4 * np.abs(jl).max(), err
    assert set(cache) == set(jcache) == {
        "k", "v", "k_scale", "v_scale", "xk", "xv", "xk_scale", "xv_scale",
        "enc_len"}
    for name in ("k", "v", "xk", "xv"):
        assert cache[name].dtype == torch.int8, name
        assert cache[f"{name}_scale"].dtype == torch.float32, name
        got = (cache[name].float() * cache[f"{name}_scale"]).numpy()
        want = np.asarray(jcache[name], np.float32) * np.asarray(
            jcache[f"{name}_scale"])
        scale = np.asarray(jcache[f"{name}_scale"])
        # codes may differ by one where float rounding crosses a tie
        assert (np.abs(got - want) <= 1.01 * scale + 1e-6).all(), name
        np.testing.assert_allclose(cache[f"{name}_scale"].numpy(), scale,
                                   **TOL, err_msg=name)
    np.testing.assert_array_equal(cache["enc_len"].numpy(),
                                  np.asarray(jcache["enc_len"]))
    # past the prefill: zero codes and zero scales
    assert not cache["k"][:, :, P:].any() and not cache["k_scale"][:, :, P:].any()


def test_greedy_tokens_match_reference(pair):
    """The CI command's request: equal greedy tokens from one set of
    quantized weights."""
    prompts = pair["prompts"]
    jtoks, jdone = jserve.generate(pair["jmq"], pair["jqp"],
                                   jnp.asarray(prompts), gen_len=GEN,
                                   cache_len=CACHE_LEN)
    tops.ATTN_DECODE_DISPATCH.clear()
    toks, done = serve.generate(pair["tmq"], pair["tqp"],
                                torch.from_numpy(prompts), gen_len=GEN,
                                cache_len=CACHE_LEN)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert [k for k, _ in tops.ATTN_DECODE_DISPATCH.items()] == [
        "attn_dec|B2|S24|KV2|G2|D32|int8"]


def test_view_and_fused_int8_reads_agree(pair):
    prompts = torch.from_numpy(pair["prompts"])
    fused, _ = serve.generate(pair["tmq"], pair["tqp"], prompts, gen_len=6,
                              cache_len=CACHE_LEN)
    view_m = build_model(pair["tmq"].cfg.replace(attn_decode="view"))
    view, _ = serve.generate(view_m, pair["tqp"], prompts, gen_len=6,
                             cache_len=CACHE_LEN)
    np.testing.assert_array_equal(fused.numpy(), view.numpy())


def test_store_and_quantize_cache_match_reference():
    rng = np.random.default_rng(8)
    fresh = rng.normal(size=(2, 1, 3, 16)).astype(np.float32)
    cache = {"k": np.zeros((2, 6, 3, 16), np.int8),
             "k_scale": np.zeros((2, 6, 3, 1), np.float32)}
    jnew = jcommon.store_kv_token({n: jnp.asarray(a) for n, a in cache.items()},
                                  "k", jnp.asarray(fresh), jnp.int32(4))
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tcommon.store_kv_token(tcache, "k", torch.from_numpy(fresh), 4)
    for n in cache:
        np.testing.assert_array_equal(tcache[n].numpy(), np.asarray(jnew[n]))
    # the prefill cache through the cache defs
    cfg = smoke_config(get_config("whisper-medium")).replace(kv_quant="int8")
    jcfg = jsmoke_config(jget_config("whisper-medium")).replace(kv_quant="int8")
    defs = build_model(cfg).cache_defs(2, 8)
    jdefs = jbuild_model(jcfg).cache_defs(2, 8)
    pre = {n: rng.normal(size=(2, 2, 4, 2, 32)).astype(np.float32)
           for n in ("k", "v", "xk", "xv")}
    pre["enc_len"] = np.full((2, 2), 4, np.int32)
    got = serve.quantize_cache_to_defs(
        {n: torch.from_numpy(a) for n, a in pre.items()}, defs)
    want = jserve.quantize_cache_to_defs(
        {n: jnp.asarray(a) for n, a in pre.items()}, jdefs)
    assert set(got) == set(want)
    for n in got:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def test_cache_bytes_match_reference_at_full_width():
    """Cache bytes of the full-width serving request (B=4, P=256, gen 32:
    ``cache_defs(4, 576)``, 288 self and 288 cross rows): the bf16 fp cache
    and the int8 cache, 1.88x apart, as the reference counts them."""
    cfg = get_config("whisper-medium")
    assert serve.resolve_cache_len(cfg, 288, 256, 32) == 576
    for kv in ("fp", "int8"):
        m = build_model(cfg.replace(kv_quant=kv))
        jm = jbuild_model(jget_config("whisper-medium").replace(kv_quant=kv))
        got = serve.cache_nbytes(m.cache_defs(4, 576), m.cfg.param_dtype)
        want = jserve.cache_nbytes(jm.cache_defs(4, 576), jm.cfg.param_dtype)
        assert got == want == {"fp": 226_492_800, "int8": 120_324_480}[kv]


def test_serve_cli_int8_smoke_on_cpu(capsys):
    """The CI command on the port's CLI prints the reference's lines."""
    tops.ATTN_DECODE_DISPATCH.clear()
    HEALTH.reset()
    serve.main(["--arch", "whisper-medium", "--smoke", "--batch", "2",
                "--prompt-len", "16", "--gen", "8", "--quant", "int8",
                "--kv-quant", "int8", "--conv-backend", "sliding_pallas",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert ("[serve] --quant: 2 conv weight(s) int8, 2 calibrated site(s), "
            "1 chained") in out
    assert "[serve] kv-cache bytes: 27664 (fp 98320, ratio 3.55x)" in out
    assert ("[serve] attn-decode: impl=plain "
            "key=attn_dec|B2|S24|KV2|G2|D32|int8 calls=28") in out
    assert "[serve] generated (2, 8) x1" in out and "health:" not in out
