"""Decode attention of the PyTorch port against the JAX reference, on the CPU.

The same numpy q/k/v/lengths go through the reference's blocked pure-JAX
path (``attention_decode_jax``) and its oracle (``attention_decode_ref``),
and through the port's plain blocked version, its oracle and the wrapper
(which runs the plain version on a CPU tensor). Cases cover GQA ratios,
cache lengths that are not a multiple of the block, and ragged lengths
including 0 (a zero row) and S (the whole cache). The int8 cache (codes
and per-row scales from the reference's ``quantize_int8``) goes through the
reference's int8 paths and the port's, within ``ITOL``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import attention_decode as JA  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.optim.compress import quantize_int8 as jquantize_int8  # noqa: E402
from repro_torch.kernels import attention_decode as TA  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)  # f32: the reference tests' own tolerance
BTOL = dict(rtol=5e-2, atol=5e-2)
ITOL = dict(rtol=3e-4, atol=3e-4)  # int8 cache: scale folds reorder rounding
BLOCK = 16


def _case(seed, B=4, S=37, KV=2, G=2, D=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, KV, G, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    lengths = np.array([0, 1, S // 2, S][:B], np.int32)
    return q, k, v, lengths


def _port_all(q, k, v, lengths):
    qt, kt, vt, lt = map(torch.from_numpy, (q, k, v, lengths))
    return {
        "plain_block": TA.attention_decode_plain(qt, kt, vt, lt, block_s=BLOCK),
        "plain_one": TA.attention_decode_plain(qt, kt, vt, lt, block_s=k.shape[1]),
        "ref": TA.attention_decode_ref(qt, kt, vt, lt),
        "wrapper": TA.decode_attention(qt, kt, vt, lt),
    }


@pytest.mark.parametrize("S", [37, 50])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_port_matches_reference(G, S):
    q, k, v, lengths = _case(G * 100 + S, S=S, G=G)
    args = tuple(map(jnp.asarray, (q, k, v)))
    jl = jnp.asarray(lengths)
    want_blocked = np.asarray(JA.attention_decode_jax(*args, lengths=jl,
                                                      block_s=BLOCK))
    want_ref = np.asarray(JA.attention_decode_ref(*args, lengths=jl))
    for name, got in _port_all(q, k, v, lengths).items():
        assert got.dtype == torch.float32 and got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), want_blocked, **TOL, err_msg=name)
        np.testing.assert_allclose(got.numpy(), want_ref, **TOL, err_msg=name)
    got = _port_all(q, k, v, lengths)["wrapper"].numpy()
    assert not got[0].any(), "length 0 must give a zero row"


@pytest.mark.parametrize("G", [1, 4])
def test_bf16_cache(G):
    q, k, v, lengths = _case(7 + G, S=45, G=G)
    kb = jnp.asarray(k).astype(jnp.bfloat16)
    vb = jnp.asarray(v).astype(jnp.bfloat16)
    want = np.asarray(JA.attention_decode_ref(
        jnp.asarray(q).astype(jnp.bfloat16), kb, vb, lengths=jnp.asarray(lengths)))
    qt = torch.from_numpy(q).to(torch.bfloat16)
    kt = torch.from_numpy(k).to(torch.bfloat16)
    vt = torch.from_numpy(v).to(torch.bfloat16)
    got = TA.decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **BTOL)


def test_softmax_step_guards_match_reference():
    """All-masked blocks: a carry that holds data stays untouched, an empty
    carry stays empty; _finish maps l == 0 to a zero row."""
    rng = np.random.default_rng(3)
    s = rng.normal(size=(3, 2, 5)).astype(np.float32)
    s[0] = -np.inf  # row 0 fully masked
    s[1, :, 3:] = -np.inf
    m_prev = np.array([[1.5, -np.inf], [0.2, 0.1], [-np.inf, -np.inf]], np.float32)
    l_prev = np.array([[2.0, 0.0], [1.0, 3.0], [0.0, 0.0]], np.float32)
    want = JA._softmax_step(jnp.asarray(s), jnp.asarray(m_prev),
                            jnp.asarray(l_prev), axis=-1)
    got = TA._softmax_step(*map(torch.from_numpy, (s, m_prev, l_prev)), dim=-1)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert got[2][0, 0] == 1.0 and got[3][0, 0] == 2.0  # carry untouched
    acc = rng.normal(size=(3, 2, 4)).astype(np.float32)
    fin = TA._finish(got[3], torch.from_numpy(acc * 0))
    np.testing.assert_array_equal(
        fin.numpy(), np.asarray(JA._finish(want[3], jnp.asarray(acc * 0))))


def test_ops_dispatch_key_matches_reference():
    q, k, v, lengths = _case(9, B=2, S=20, KV=2, G=4, D=32)
    tops.ATTN_DECODE_DISPATCH.clear()
    qt = torch.from_numpy(q).reshape(2, 8, 32)
    out = tops.attention_decode(qt, torch.from_numpy(k), torch.from_numpy(v),
                                lengths=torch.from_numpy(lengths[:2]))
    assert out.shape == (2, 8, 32)
    key = jautotune.attn_dec_key(2, 20, 2, 4, 32, "float32")
    assert dict(tops.ATTN_DECODE_DISPATCH.items()) == {key: "plain"}
    assert tops.ATTN_DECODE_DISPATCH.count(key) == 1


def test_wrapper_refuses_other_devices_and_bad_shapes():
    q = torch.empty((1, 2, 2, 8), device="meta")
    k = torch.empty((1, 5, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no decode_attention for device"):
        TA.decode_attention(q, k, k, torch.empty((1,), device="meta"))
    with pytest.raises(ValueError, match="does not match"):
        TA.decode_attention(torch.zeros(1, 2, 2, 8), torch.zeros(1, 5, 3, 8),
                            torch.zeros(1, 5, 3, 8), torch.zeros(1))


def _int8(a):
    """Codes and (B, S, KV, 1) scales from the reference's quantizer."""
    q, sc = jquantize_int8(jnp.asarray(a))
    return np.array(q, np.int8), np.array(sc)


@pytest.mark.parametrize("S", [37, 50])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_int8_cache_matches_reference(G, S):
    q, k, v, lengths = _case(G * 10 + S + 1, S=S, G=G)
    kq, ks = _int8(k)
    vq, vs = _int8(v)
    jargs = [jnp.asarray(a) for a in (q, kq, vq, ks, vs)]
    jl = jnp.asarray(lengths)
    wants = {
        "jax_blocked": np.asarray(JA.attention_decode_jax(
            *jargs, lengths=jl, block_s=BLOCK)),
        "jax_one": np.asarray(JA.attention_decode_jax(*jargs, lengths=jl,
                                                      block_s=S)),
        "ref": np.asarray(JA.attention_decode_ref(*jargs, lengths=jl)),
    }
    t = [torch.from_numpy(a) for a in (q, kq, vq, lengths, ks, vs)]
    gots = {
        "plain_block": TA.attention_decode_plain(*t, block_s=BLOCK),
        "plain_one": TA.attention_decode_plain(*t, block_s=S),
        "ref": TA.attention_decode_ref(*t),
        "wrapper": TA.decode_attention(*t),
    }
    for gname, got in gots.items():
        assert got.dtype == torch.float32 and got.shape == q.shape
        for wname, want in wants.items():
            np.testing.assert_allclose(got.numpy(), want, **ITOL,
                                       err_msg=f"{gname} vs {wname}")
    assert not gots["wrapper"][0].numpy().any(), "length 0 gives a zero row"


def test_int8_cross_cache_is_masked_by_length_not_by_value():
    """The cross cache is zero-padded past the encoder length with zero
    codes and zero scales; a zero key scores 0, not -inf, so the read must
    mask those rows by length: the result equals attention over the
    unpadded rows alone."""
    q, k, v, _ = _case(21, B=3, S=40, G=2)
    kq, ks = _int8(k)
    vq, vs = _int8(v)
    enc = np.array([40, 23, 9], np.int32)
    for a in (kq, ks, vq, vs):
        for b, n in enumerate(enc):
            a[b, n:] = 0
    t = [torch.from_numpy(a) for a in (q, kq, vq, enc, ks, vs)]
    got = TA.decode_attention(*t).numpy()
    for b, n in enumerate(enc):
        rows = [jnp.asarray(a[b : b + 1, :n]) for a in (kq, vq, ks, vs)]
        want = np.asarray(JA.attention_decode_ref(
            jnp.asarray(q[b : b + 1]), *rows, lengths=jnp.asarray([n])))
        np.testing.assert_allclose(got[b : b + 1], want, **ITOL)
    unmasked = TA.decode_attention(*t[:3], torch.full((3,), 40), *t[4:])
    assert not np.allclose(unmasked.numpy()[1:], got[1:], **ITOL)


def test_int8_dispatch_key_and_scale_checks():
    q, k, v, lengths = _case(9, B=2, S=20, KV=2, G=4, D=32)
    kq, ks = _int8(k)
    vq, vs = _int8(v)
    tops.ATTN_DECODE_DISPATCH.clear()
    out = tops.attention_decode(
        torch.from_numpy(q).reshape(2, 8, 32), torch.from_numpy(kq),
        torch.from_numpy(vq), lengths=torch.from_numpy(lengths[:2]),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    assert out.shape == (2, 8, 32)
    key = jautotune.attn_dec_key(2, 20, 2, 4, 32, "int8")
    assert dict(tops.ATTN_DECODE_DISPATCH.items()) == {key: "plain"}
    qt, kt, vt, lt = map(torch.from_numpy, (q, kq, vq, lengths[:2]))
    with pytest.raises(ValueError, match="needs its k_scale"):
        tops.attention_decode(qt.reshape(2, 8, 32), kt, vt, lengths=lt)
    with pytest.raises(ValueError, match="travel as a pair"):
        TA.decode_attention(qt, kt, vt, lt, torch.from_numpy(ks), None)
    with pytest.raises(ValueError, match="are not"):
        TA.decode_attention(qt, kt, vt, lt, torch.from_numpy(ks[..., 0]),
                            torch.from_numpy(vs[..., 0]))
    with pytest.raises(ValueError, match="only an int8 cache"):
        TA.decode_attention(qt, torch.from_numpy(k), torch.from_numpy(v), lt,
                            torch.from_numpy(ks), torch.from_numpy(vs))
