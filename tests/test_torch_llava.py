"""The port's llava serving slice (the dense decoder, the projector and the
patch embedding) against the JAX reference, on the CPU.

llava-next-34b's and qwen3-1.7b's smoke configs (float32, 2 layers, d 128;
llava with 16 patches, qwen3 with qk_norm and tied embeddings). The
reference makes the weights (``model.init(jax.random.key(0))``) and they
are carried across with ``repro_torch.bridge.params_from_numpy``. The
patch embedding runs the reference's ``patch_embed`` on its sliding twin
and the port's on ``sliding`` and ``sliding_pallas`` (the 2-D kernel's
plain version on a CPU tensor). The reference's serve CLI fails for llava
(its cache and decode positions leave out the patch prefix; ROADMAP), so
the greedy tokens are held to a loop over the reference's own
``Llava.prefill`` / ``decode_step`` at positions num_patches + P + i, its
cache padded by the reference's ``pad_cache_to_defs``. ``TOL`` is
``tests/test_kernels.py``'s.

Numerics. The reference's init draws every layer-stacked weight with std
1/sqrt(layers) (the fan-in quirk, ROADMAP Queue 3): at the smoke config's
2 layers and d 128 the keys reach |k| = 15, and one element of llava's
float32 cache lies 4.6e-4 from the reference's (3e-5 of the largest) for
summing in another order. Prefill logits, the cache, a decode step and the
loss are therefore held to ``TOL`` on the same weights rescaled to std
1/sqrt(input width), where the model is well conditioned; the greedy
tokens are held equal on the reference's own init.
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
from repro.models import llava as jllava  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import PORTED_ARCHS, get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import llava as tllava  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402

TOL = dict(rtol=3e-4, atol=3e-4)  # tests/test_kernels.py TOL
B, P, GEN = 2, 8, 6
ARCHS = ("llava-next-34b", "qwen3-1.7b")
FIELDS = ("name", "family", "num_layers", "d_model", "num_heads",
          "num_kv_heads", "d_ff", "vocab_size", "head_dim", "activation",
          "qk_norm", "tie_embeddings", "rope_theta", "norm_eps", "frontend",
          "num_patches", "param_dtype", "attn_chunk", "grad_accum")


def _images(seed, n, tiles=1):
    """``n`` requests of ``tiles`` 56x56 image tiles (16 patches each), as
    (n * tiles, 56, 56, 3), and the patch weight (14, 14, 3, 1152) with its
    bias."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(n * tiles, 56, 56, 3)).astype(np.float32)
    w = (rng.normal(size=(14, 14, 3, 1152)) / np.sqrt(588)).astype(np.float32)
    b = (0.1 * rng.normal(size=(1152,))).astype(np.float32)
    return img, w, b


def _batch(cfg, seed=0, labels=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(2, cfg.vocab_size, size=(B, P)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(B, cfg.num_patches, 1152)).astype(np.float32)
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)
        out["labels"][:, -1] = -1
    return out


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _conditioned(tree, defs, path=()):
    """The reference's weights with every layer-stacked fan-in weight
    rescaled from std 1/sqrt(layers) to 1/sqrt(input width) (the attention
    output projection contracts heads x head_dim)."""
    if isinstance(tree, dict):
        return {k: _conditioned(tree[k], defs[k], path + (k,)) for k in tree}
    if path[0] == "blocks" and defs.init == "fan_in":
        fan = defs.shape[1] * (defs.shape[2] if path[-1] == "wo" else 1)
        return (tree * np.sqrt(defs.shape[0] / fan)).astype(tree.dtype)
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
    assert arch in PORTED_ARCHS
    for full in (True, False):
        got, want = get_config(arch), jget_config(arch)
        if not full:
            got, want = smoke_config(got), jsmoke_config(want)
        for f in FIELDS:
            assert getattr(got, f) == getattr(want, f), f
        assert got.resolved_head_dim == want.resolved_head_dim


def test_param_defs_and_bridge_match_reference(ref):
    """The same paths and shapes, the projector and qk norms among them;
    the bridged tree equals the reference's leaf for leaf."""
    from repro_torch.distributed.sharding import iter_leaves

    want = {"/".join(str(getattr(k, "key", k)) for k in p): a
            for p, a in jax.tree_util.tree_leaves_with_path(ref["jp"])}
    got = dict(iter_leaves(ref["tp"]))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[path]), path)
    if ref["jcfg"].family == "vlm":
        assert {"projector/w1", "projector/b1", "projector/w2"} <= set(got)
    else:
        assert {"blocks/attn/q_norm", "blocks/attn/k_norm"} <= set(got)
        assert "embed/unembed" not in got  # tied


# -- patch embedding and projector -------------------------------------------------

@pytest.mark.parametrize("with_bias", [True, False])
def test_patch_embed_matches_reference(with_bias):
    img, w, b = _images(1, 2, tiles=2)
    bias = b if with_bias else None
    want = np.asarray(jllava.patch_embed(
        jnp.asarray(w), jnp.asarray(img), backend="sliding",
        bias=None if bias is None else jnp.asarray(bias)))
    assert want.shape == (4, 16, tllava.VISION_DIM)
    for backend in ("sliding", "sliding_pallas"):
        got = tllava.patch_embed(torch.from_numpy(w), torch.from_numpy(img),
                                 backend=backend,
                                 bias=None if bias is None else torch.from_numpy(bias))
        assert got.shape == want.shape and got.dtype == torch.float32
        _close(got, want, backend)


def test_patch_embed_observes_its_site_and_refuses_int8():
    img, w, _ = _images(2, 1)
    calib = quant.Calibration()
    with quant.collecting(calib):
        tllava.patch_embed(torch.from_numpy(w), torch.from_numpy(img),
                           backend="sliding_pallas")
    assert calib.seen == ["llava/patch_embed"]
    with pytest.raises(NotImplementedError, match="int8 conv2d"):
        tllava.patch_embed(torch.from_numpy(w), torch.from_numpy(img),
                           backend="sliding_pallas", precision="w8a8")


def test_projector_matches_reference():
    cfg = jsmoke_config(jget_config("llava-next-34b"))
    jp = jbuild_model(cfg).init(jax.random.key(3))["projector"]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(4)
    patches = rng.normal(size=(2, 5, 1152)).astype(np.float32)
    want = jtransformer.projector_apply(jp, jnp.asarray(patches))
    got = ttransformer.projector_apply(tp, torch.from_numpy(patches))
    _close(got, want, "fp")
    # the int8-codes branch: codes of a requantizing patch embedding
    codes = rng.integers(-127, 128, size=(2, 5, 1152)).astype(np.int8)
    x_scale = np.float32(0.02)
    want = jtransformer.projector_apply(jp, jnp.asarray(codes),
                                        x_scale=jnp.asarray(x_scale))
    with quant.counting_dequants() as log:
        got = ttransformer.projector_apply(tp, torch.from_numpy(codes),
                                           x_scale=torch.tensor(x_scale))
    assert log == ["llava/projector"]
    _close(got, want, "int8 codes")
    with pytest.raises(ValueError, match="x_scale"):
        ttransformer.projector_apply(tp, torch.from_numpy(codes))


# -- the decoder ---------------------------------------------------------------------

def test_prefill_decode_step_and_loss_match_reference(ref):
    jm, jp, tm, tp = ref["jm"], ref["jcond"], ref["tm"], ref["tcond"]
    batch = _batch(ref["jcfg"], labels=True)
    jlogits, jcache = jm.prefill(jp, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        logits, cache = tm.prefill(tp, _tb(batch))
    _close(logits, jlogits, "prefill logits")
    prefix = ref["jcfg"].num_patches if ref["jcfg"].family == "vlm" else 0
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == jcache[k].shape
        assert cache[k].shape[2] == prefix + P
        _close(cache[k], jcache[k], f"cache {k}")
    # one decode step at the first free position of a padded cache
    n = prefix + P + 2
    defs = jm.cache_defs(B, n)
    jc = jserve.pad_cache_to_defs(jcache, jserve.init_cache_concrete(jm, B, n),
                                  defs)
    tc = serve.pad_cache_to_defs(cache, tm.cache_defs(B, n), "float32")
    tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[:, None]
    jstep, jc = jm.decode_step(jp, jc, jnp.asarray(tok), prefix + P)
    with torch.no_grad():
        step, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), prefix + P)
    _close(step, jstep, "decode step logits")
    for k in ("k", "v"):
        _close(tc[k], jc[k], f"cache {k} after the step")
    jloss = jm.loss(jp, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        loss = tm.loss(tp, _tb(batch))
    _close(loss, jloss, "loss")


def _ref_greedy(jm, jp, prompts, patches):
    """The reference's own loop: prefill with the patches, the cache padded
    to num_patches + P + GEN rows, decode at num_patches + P + i."""
    n = patches.shape[1] + P + GEN
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompts),
                                    "patches": jnp.asarray(patches)})
    cache = jserve.pad_cache_to_defs(
        cache, jserve.init_cache_concrete(jm, B, n), jm.cache_defs(B, n))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(GEN - 1):
        logits, cache = jm.decode_step(jp, cache, tok,
                                       patches.shape[1] + P + i)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


def test_generate_with_patch_embeddings_matches_reference_loop():
    """Images through ``patch_embed`` (the 2-D sliding kernel's path), then
    the port's ``generate`` with those patches: the same greedy tokens as
    the reference's loop on the reference's own patch embedding."""
    arch = "llava-next-34b"
    jm = jbuild_model(jsmoke_config(jget_config(arch)))
    jp = jm.init(jax.random.key(1))
    tm = build_model(smoke_config(get_config(arch)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           defs=tm.param_defs())
    img, w, b = _images(5, B)
    jpatches = np.asarray(jllava.patch_embed(jnp.asarray(w), jnp.asarray(img),
                                             bias=jnp.asarray(b)))
    prompts = _batch(jm.cfg)["tokens"]
    want = _ref_greedy(jm, jp, prompts, jpatches)
    patches = tllava.patch_embed(torch.from_numpy(w), torch.from_numpy(img),
                                 backend="sliding_pallas",
                                 bias=torch.from_numpy(b))
    toks, done = serve.generate(tm, tp, torch.from_numpy(prompts),
                                gen_len=GEN, cache_len=P + GEN,
                                patches=patches)
    np.testing.assert_array_equal(toks.numpy(), want)
    assert done.shape == (B,)


def test_decode_never_overwrites_a_patch_row(monkeypatch):
    """Regression for the reference's serve fault: the cache holds the
    patch prefix + prompt + generated rows, decode writes at prefix + P +
    i, and the prefill's rows (patches and prompt) are left as they were."""
    cfg = smoke_config(get_config("llava-next-34b"))
    tm = build_model(cfg)
    tp = tm.init(torch.Generator().manual_seed(2))
    batch = _tb(_batch(cfg))
    prompts = batch["tokens"]
    n_pre = cfg.num_patches + P
    assert serve.prefix_len(cfg) == cfg.num_patches
    assert serve.prefix_len(cfg, batch["patches"][:, :5]) == 5
    assert serve.resolve_cache_len(cfg, P + GEN, P, GEN,
                                   cfg.num_patches) == n_pre + GEN
    with torch.no_grad():
        _, fresh = serve.prefill_cache(tm, tp, prompts, cache_len=P + GEN,
                                       gen_len=GEN, patches=batch["patches"])
    assert fresh["k"].shape[2] == n_pre + GEN
    seen = []
    step = tm.decode_step

    def spy(params, cache, tokens, pos):
        seen.append((pos, cache))
        return step(params, cache, tokens, pos)

    monkeypatch.setattr(tm, "decode_step", spy)
    serve.generate(tm, tp, prompts, gen_len=GEN, cache_len=P + GEN,
                   patches=batch["patches"])
    assert [pos for pos, _ in seen] == [n_pre + i for i in range(GEN - 1)]
    cache = seen[-1][1]
    for k in ("k", "v"):
        assert torch.equal(cache[k][:, :, :n_pre], fresh[k][:, :, :n_pre])
        assert cache[k][:, :, n_pre:n_pre + GEN - 1].abs().amax() > 0
        assert not cache[k][:, :, n_pre + GEN - 1:].any()


def test_zero_patches_serve_as_the_reference_serve_batch():
    """Without patches the serving batch carries zeros of (B, num_patches,
    1152), as the reference's ``serve_batch`` does."""
    cfg = smoke_config(get_config("llava-next-34b"))
    tm = build_model(cfg)
    prompts = torch.from_numpy(_batch(cfg)["tokens"])
    got = serve.serve_batch(tm, B, P, prompts)
    want = jserve.serve_batch(jbuild_model(jsmoke_config(jget_config(
        "llava-next-34b"))), B, P, jnp.asarray(prompts.numpy()))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["patches"].numpy(),
                                  np.asarray(want["patches"]))
    assert got["patches"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_completes(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out
    cfg = smoke_config(get_config(arch))
    S = serve.prefix_len(cfg) + 8 + 4
    assert f"attn_dec|B2|S{S}|KV2|G2|D32|float32" in out
