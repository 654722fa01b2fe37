"""The decode-attention kernel's split choice (``decode_splits``) and its
split-and-merge, on the CPU.

``decode_splits(bkv, n)`` gives the kernel its splits of the cache rows; a
slot of length ``len`` uses the first ceil(len / rows) of them. The tests
hold the contract the kernel relies on: the used splits cover exactly
min(len, S) rows and each holds at least one; one split for a tiny cache;
enough blocks for the card at llava's shape. ``_split_merge`` transcribes
what the kernel computes from those splits (one softmax step over each
split's rows, then the merge in split order, with the empty-carry guards)
in plain torch, and is held to ``attention_decode_plain``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import attention_decode as TA  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_torch_attention_decode.py TOL


@pytest.mark.parametrize("bkv", [1, 2, 8, 32, 64, 128, 396, 1000])
@pytest.mark.parametrize("n", [1, 2, 24, 63, 64, 65, 200, 288, 1000, 3168,
                               32768])
def test_splits_cover_the_rows(bkv, n):
    splits, rows = TA.decode_splits(bkv, n)
    assert splits >= 1 and 1 <= rows <= TA.MAX_SPLIT_ROWS
    assert (splits - 1) * rows < n <= splits * rows  # every split holds a row
    for length in sorted({0, 1, rows - 1, rows, rows + 1, n // 2, n - 1, n}):
        if not 0 <= length <= n:
            continue
        used = -(-length // rows)  # the splits a slot of this length runs
        assert used <= splits
        spans = [(i * rows, min(length, (i + 1) * rows)) for i in range(used)]
        assert all(e > s for s, e in spans)  # each holds a valid row
        covered = [r for s, e in spans for r in range(s, e)]
        assert covered == list(range(length))  # exactly min(length, S)


@pytest.mark.parametrize("bkv", [1, 4, 64, 1000])
@pytest.mark.parametrize("n", [1, 8, 24, 64])
def test_tiny_cache_is_one_split(bkv, n):
    assert TA.decode_splits(bkv, n) == (1, n)


@pytest.mark.parametrize("B,S,KV", [(4, 3168, 8), (4, 288, 8), (4, 288, 16),
                                    (1, 32768, 1)])
def test_splits_fill_the_card(B, S, KV):
    """llava (4, 3168, 8), jamba (4, 288, 8), whisper (4, 288, 16): at least
    one block an SM of the H100's (``build.DEFAULT_SMS``) wherever the
    rows allow it; never more splits than ``BLOCKS_PER_SM`` blocks an SM
    would need."""
    splits, rows = TA.decode_splits(B * KV, S)
    sms = build.DEFAULT_SMS
    assert splits * B * KV >= min(sms, -(-S // TA.MIN_SPLIT_ROWS) * B * KV)
    assert rows >= min(S, TA.MIN_SPLIT_ROWS)
    if (B, S, KV) == (4, 3168, 8):
        assert splits * B * KV >= 132
        assert splits <= TA.BLOCKS_PER_SM * sms // (B * KV)


def _split_merge(q, k, v, lengths, k_scale=None, v_scale=None):
    """The kernel's function in plain torch: per (slot, head) the splits of
    ``decode_splits``, each one ``_softmax_step`` over its rows (an empty
    carry; the guards and the scale folds of the int8 cache), then the
    merge in split order and ``_finish``; a length-0 slot gives a zero
    row."""
    B, KV, G, D = q.shape
    S = k.shape[1]
    _, rows = TA.decode_splits(B * KV, S)
    sm = D ** -0.5
    out = torch.zeros((B, KV, G, D))
    for b in range(B):
        length = max(0, min(int(lengths[b]), S))
        for h in range(KV):
            qf = q[b, h].float()  # (G, D)
            parts = []
            for s0 in range(0, length, rows):
                s1 = min(length, s0 + rows)
                s = qf @ k[b, s0:s1, h].float().T  # (G, rows of the split)
                if k_scale is None:
                    s = s * sm
                else:
                    s = s * (k_scale[b, s0:s1, h, 0] * sm)
                m, p, _, l = TA._softmax_step(
                    s, torch.full((G,), -math.inf), torch.zeros(G), dim=1)
                pw = p if v_scale is None else p * v_scale[b, s0:s1, h, 0]
                parts.append((m, l, pw @ v[b, s0:s1, h].float()))
            if not parts:
                continue
            M = torch.stack([m for m, _, _ in parts]).amax(0)
            Ms = torch.where(torch.isfinite(M), M, torch.zeros_like(M))
            L = torch.zeros(G)
            A = torch.zeros((G, D))
            for m, l, acc in parts:
                c = torch.where(torch.isfinite(m), torch.exp(m - Ms),
                                torch.zeros_like(m))
                L = L + c * l
                A = A + c[:, None] * acc
            out[b, h] = TA._finish(L, A)
    return out


@pytest.mark.parametrize("S,lengths", [(37, [0, 1, 18, 37]),
                                       (300, [0, 63, 64, 65]),
                                       (700, [129, 300, 699, 700])])
@pytest.mark.parametrize("G,D", [(1, 16), (3, 24), (8, 8)])
def test_split_merge_matches_plain(S, lengths, G, D):
    """Split boundaries +- 1, lengths 0, 1 and S; G 1, 3 and 8."""
    rng = np.random.default_rng(S + G + D)
    B, KV = 4, 2
    q = torch.from_numpy(rng.normal(size=(B, KV, G, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S, KV, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S, KV, D)).astype(np.float32))
    ln = torch.tensor(lengths, dtype=torch.int32)
    got = _split_merge(q, k, v, ln)
    want = TA.attention_decode_plain(q, k, v, ln)
    torch.testing.assert_close(got, want, **TOL)
    assert not got[0].any() or lengths[0] > 0


@pytest.mark.parametrize("S,lengths", [(300, [0, 65, 200, 300])])
def test_split_merge_int8_matches_plain(S, lengths):
    """The int8 cache: K scale after the dot, V scale into p."""
    rng = np.random.default_rng(7)
    B, KV, G, D = 4, 2, 4, 16
    q = torch.from_numpy(rng.normal(size=(B, KV, G, D)).astype(np.float32))
    k = torch.from_numpy(rng.integers(-127, 128, size=(B, S, KV, D)).astype(
        np.int8))
    v = torch.from_numpy(rng.integers(-127, 128, size=(B, S, KV, D)).astype(
        np.int8))
    ks = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(B, S, KV, 1)).astype(
        np.float32))
    vs = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(B, S, KV, 1)).astype(
        np.float32))
    ln = torch.tensor(lengths, dtype=torch.int32)
    got = _split_merge(q, k, v, ln, ks, vs)
    want = TA.attention_decode_plain(q, k, v, ln, ks, vs)
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
