"""The decode-attention kernel (rows 2 and 2b) against its plain version, on
the card: float32, bfloat16 and int8 caches, G in {1, 7, 8}, D in {64,
128, 256}, lengths 0, 1, a split boundary +- 1 and S, and two calls bitwise
equal.

Needs an NVIDIA card and ``nvcc``; skips without a card. It imports neither
jax nor the JAX package, so it runs where the port runs (``--noconftest``:
the suite's conftest imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_attention_card.py -m cuda
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import attention_decode as TA  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

# tests/test_torch_attention_decode.py TOL, BTOL, ITOL
TOL = dict(rtol=2e-5, atol=2e-5)  # f32: the reference tests' own tolerance
BTOL = dict(rtol=5e-2, atol=5e-2)
ITOL = dict(rtol=3e-4, atol=3e-4)  # int8 cache: scale folds reorder rounding


@pytest.fixture
def card():
    """Skip without a card; full float32 (TF32 off) with one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repro_torch

    repro_torch.resolve_device("cuda")
    return "cuda"


def _inputs(seed, B, S, KV, G, D, kind, lengths, dev):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, KV, G, D)).astype(np.float32))
    if kind == "int8":
        k = torch.from_numpy(rng.integers(-127, 128, size=(B, S, KV, D)).astype(
            np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, size=(B, S, KV, D)).astype(
            np.int8))
        ks, vs = (torch.from_numpy(rng.uniform(2e-3, 2e-2, size=(
            B, S, KV, 1)).astype(np.float32)).to(dev) for _ in range(2))
        q = q.to(torch.bfloat16)
    else:
        dt = getattr(torch, kind)
        k = torch.from_numpy(rng.normal(size=(B, S, KV, D)).astype(
            np.float32)).to(dt)
        v = torch.from_numpy(rng.normal(size=(B, S, KV, D)).astype(
            np.float32)).to(dt)
        q = q.to(dt)
        ks = vs = None
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q.to(dev), k.to(dev), v.to(dev), ln, ks, vs


def _lengths(B, S, KV):
    """For 5 slots: 0, 1, a split boundary - 1 and + 1, S (the splits this
    card's launch takes); else 0, S."""
    if B < 5:
        return [0, S][:B]
    sms = build.sm_count(torch.device("cuda"))
    _, rows = TA.decode_splits(B * KV, S, sms)
    assert rows + 1 < S
    return [0, 1, rows - 1, rows + 1, S]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("G,D", [(1, 64), (7, 128), (8, 128), (8, 256),
                                 (1, 256), (7, 64)])
@pytest.mark.parametrize("B,S,KV", [(5, 300, 2), (5, 3168, 1), (2, 24, 3)])
def test_decode_attention_kernel_matches_plain(card, B, S, KV, G, D, kind):
    lens = _lengths(B, S, KV)
    q, k, v, ln, ks, vs = _inputs(S + G + D, B, S, KV, G, D, kind, lens, card)
    counter = "launches_int8" if kind == "int8" else "launches"
    before = getattr(TA.decode_attention, counter)
    got = TA.decode_attention(q, k, v, ln, ks, vs)
    assert getattr(TA.decode_attention, counter) == before + 1
    want = TA.attention_decode_plain(q, k, v, ln, ks, vs)
    tol = {"float32": TOL, "bfloat16": BTOL, "int8": ITOL}[kind]
    assert got.dtype == torch.float32 and got.shape == (B, KV, G, D)
    torch.testing.assert_close(got, want, **tol)
    if kind != "float32":  # the plain version on the same widened operands
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert not got[0].any(), "a length-0 slot gives a zero row"
    again = TA.decode_attention(q, k, v, ln, ks, vs)
    assert torch.equal(got, again), "two calls are bitwise equal"


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 3, 20, 33, 200])
def test_decode_attention_kernel_odd_head_dims(card, D):
    """Head dims that are not a multiple of 8 (staged element by element,
    the last column pair half empty)."""
    for kind in ("float32", "bfloat16", "int8"):
        q, k, v, ln, ks, vs = _inputs(D, 3, 150, 2, 3, D, kind, [0, 77, 150],
                                      card)
        got = TA.decode_attention(q, k, v, ln, ks, vs)
        want = TA.attention_decode_plain(q, k, v, ln, ks, vs)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_decode_attention_kernel_refuses(card):
    q, k, v, ln, _, _ = _inputs(0, 2, 10, 1, 9, 64, "float32", [1, 2], card)
    with pytest.raises(ValueError, match="G <= 8"):
        TA.decode_attention(q, k, v, ln)
    with pytest.raises(TypeError):
        TA.decode_attention(q[:, :, :2].half(), k.half(), v.half(), ln)
    q, k, v, ln, _, _ = _inputs(0, 2, 10, 1, 2, 264, "float32", [1, 2], card)
    with pytest.raises(ValueError, match="D <= 256"):
        TA.decode_attention(q, k, v, ln)
