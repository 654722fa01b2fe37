"""The port's whisper serving slice against the JAX reference, on the CPU.

One set of smoke-config weights is made by the reference
(``model.init(jax.random.key(0))``) and carried across with
``repro_torch.bridge.params_from_numpy``; the same numpy mels and prompts
go to both. The reference runs ``conv_backend="sliding"`` (its Pallas conv
fails at trace under this container's jax); the port runs
``sliding_pallas``, whose kernels run their plain versions on CPU tensors.
Both compute in float32 at the smoke config.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.distributed.sharding import iter_leaves  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# float32 end to end; sums run in another order (tests/test_kernels.py TOL)
TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.fixture(scope="module")
def pair():
    jcfg = jsmoke_config(jget_config("whisper-medium")).replace(
        conv_backend="sliding")
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    cfg = smoke_config(get_config("whisper-medium")).replace(
        conv_backend="sliding_pallas")
    tm = build_model(cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           defs=tm.param_defs())
    return jm, jp, tm, tp


def _prompts(cfg, B, P, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(2, cfg.vocab_size, size=(B, P)).astype(np.int32)


@pytest.mark.parametrize("backend", ["sliding_pallas", "sliding"])
def test_encoder_matches_reference(pair, backend):
    jm, jp, tm, tp = pair
    mels = np.random.default_rng(1).normal(size=(2, 32, 80)).astype(np.float32)
    want = np.asarray(jm.encode(jp, jnp.asarray(mels)))
    tm_b = build_model(tm.cfg.replace(conv_backend=backend))
    got = tm_b.encode(tp, torch.from_numpy(mels))
    assert got.shape == want.shape == (2, 16, 128)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_prefill_and_decode_step_match_reference(pair):
    """Prefill logits, every cache leaf, and one decode step's logits."""
    jm, jp, tm, tp = pair
    B, P, cache_len = 2, 16, 48
    prompts = _prompts(tm.cfg, B, P, seed=2)
    jlogits, jcache = jserve.prefill_cache(jm, jp, jnp.asarray(prompts),
                                           cache_len=cache_len)
    logits, cache = serve.prefill_cache(tm, tp, torch.from_numpy(prompts),
                                        cache_len=cache_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert set(cache) == set(jcache)
    for name in cache:
        assert cache[name].shape == jcache[name].shape, name
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL, err_msg=name)
    tok = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1))[:, None].astype(np.int32)
    jstep, _ = jm.decode_step(jp, jcache, jnp.asarray(tok), jnp.int32(P))
    step, cache = tm.decode_step(tp, cache, torch.from_numpy(tok), P)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **TOL)
    assert cache["k"][:, :, P].abs().sum() > 0  # the new token's rows landed


@pytest.mark.parametrize("P", [16, 80])  # 80 > attn_chunk=64: chunked prefill
def test_greedy_tokens_match_reference(pair, P):
    jm, jp, tm, tp = pair
    prompts = _prompts(tm.cfg, 2, P, seed=P)
    jtoks, jdone = jserve.generate(jm, jp, jnp.asarray(prompts), gen_len=8,
                                   cache_len=P + 8)
    toks, done = serve.generate(tm, tp, torch.from_numpy(prompts), gen_len=8,
                                cache_len=P + 8)
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


def test_view_and_fused_decode_reads_agree(pair):
    _, _, tm, tp = pair
    prompts = torch.from_numpy(_prompts(tm.cfg, 2, 16, seed=5))
    fused, _ = serve.generate(tm, tp, prompts, gen_len=6, cache_len=22)
    view_m = build_model(tm.cfg.replace(attn_decode="view"))
    view, _ = serve.generate(view_m, tp, prompts, gen_len=6, cache_len=22)
    np.testing.assert_array_equal(fused.numpy(), view.numpy())


def test_init_params_matches_reference_distribution(pair):
    """Same leaves, shapes and dtypes as the reference's init, and each
    leaf's std within 10% of the reference's, including the stacked-leaf
    fan-in quirk (fan_in = the layer count for stacked weights)."""
    jm, jp, tm, _ = pair
    params = tm.init(torch.Generator().manual_seed(0))
    ref = dict(iter_leaves(jax.tree.map(np.asarray, jp)))
    got = dict(iter_leaves(params))
    assert set(got) == set(ref)
    for path, t in got.items():
        r = ref[path]
        assert tuple(t.shape) == r.shape, path
        assert str(t.dtype).removeprefix("torch.") == r.dtype.name, path
        np.testing.assert_allclose(t.float().std().item(), r.std(), rtol=0.1,
                                   err_msg=path)
    # stacked attention weight: std 1/sqrt(num_layers), not 1/sqrt(d_model)
    wq = got["decoder/attn/wq"]
    assert abs(wq.std().item() - tm.cfg.num_layers ** -0.5) < 0.05


def test_params_from_numpy_checks_shapes(pair):
    jm, jp, tm, _ = pair
    tree = jax.tree.map(np.asarray, jp)
    tree["enc_norm"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        params_from_numpy(tree, "cpu", defs=tm.param_defs())
    del tree["enc_norm"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tree, "cpu", defs=tm.param_defs())


def test_params_from_numpy_carries_bf16():
    a = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32)).astype(jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(a)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))


def test_serve_cli_smoke_on_cpu(capsys):
    tops.ATTN_DECODE_DISPATCH.clear()
    serve.main(["--arch", "whisper-medium", "--smoke", "--batch", "2",
                "--prompt-len", "16", "--gen", "4",
                "--conv-backend", "sliding_pallas", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] generated (2, 4) x1" in out
    assert ("[serve] attn-decode: impl=plain "
            "key=attn_dec|B2|S20|KV2|G2|D32|float32 calls=12") in out
    assert "[serve] kv-cache bytes:" in out and "[serve] sample:" in out


@pytest.mark.parametrize("flag", ["--run-dir", "--trace"])
def test_serve_cli_rejects_unported_flags(flag, capsys):
    """Both flags are ported now (tests/test_torch_serve_cli.py runs them);
    the parser rejects what the reference's parser rejects: --run-dir
    without its directory, --trace given a value."""
    argv, error = {"--run-dir": ([flag], "expected one argument"),
                   "--trace": ([flag + "=on"], "ignored explicit argument")}[flag]
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", *argv])
    err = capsys.readouterr().err
    assert error in err and "not ported yet" not in err


def test_unported_archs_and_families_raise():
    """Every arch of the reference resolves (rwkv6-1.6b was the last); an
    unknown arch raises KeyError and an unknown family ValueError, as in
    the reference."""
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("rwkv7-0.1b")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(smoke_config(get_config("whisper-medium")).replace(family="rnn"))


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device()
    assert repro_torch.resolve_device("cpu").type == "cpu"
