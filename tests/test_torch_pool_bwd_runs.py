"""The O(n) max-pool gradient of ``csrc/sliding_pool.cu`` (row 9), as a
numpy transcription, against ``max_pool_bwd_plain`` (the TPU kernel bodies:
each window's tie count and split, then the O(n·w) scatter).

The kernel cuts each channel into blocks of w rows, aligned at row 0, and
gives a group of threads (lanes) ``tile`` consecutive blocks, each lane its
share of each block. A window i either is one block (i % w == 0) or spans
the suffix of block i // w and the prefix of the next block. Per block the
group runs three passes over two slots a row (the block's, the next
block's), the lanes passing on what crosses from one share into the next:

  A. backward over block m: the suffix max S and the number of rows that
     attain it;
  B. forward over the windows i of block m, with the prefix max P and its
     count over block m + 1 carried along: cnt(i), the split dys(i) =
     dy(i) / max(cnt, 1) rounded to dy's type, the suffix share a(i) (when
     S(i) is the window's max) summed forward over each run of equal S, so
     that row i gets the run's sum so far when x(i) == S(i); and the prefix
     share b(e) at the window's last row e, parked in block m + 1's slot;
  C. backward over block m + 1: b summed over each run of equal P, so
     that row e gets it when x(e) == P(e) (the prefix credit pc, added to
     the row's suffix credit in block m + 1's pass B).

The tests hold the transcription to the plain version at ties (values from
a small integer set, zeros, post-relu), at w = 1, 2, L and w > L / 2, at L
not a multiple of w, at every tile and with 1 to 32 lanes: float32 within
1e-5 of max |dx|, and the per-channel mass sum dx == sum dy.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import sliding_pool as tsp  # noqa: E402


def _f32(v):
    return float(np.float32(v))


def _comb_max(a, b):
    """(max, count) of two disjoint ranges."""
    if a[0] > b[0]:
        return a
    if b[0] > a[0]:
        return b
    return (a[0], a[1] + b[1])


def max_pool_bwd_runs(x, dy, w, tile, K=1):
    """dx (L,) float32 of one channel (x (L,), dy (L - w + 1,) float32) as
    the kernel computes it: groups of K lanes, each group ``tile`` blocks of
    w rows, lane k the rows [k*sb, (k+1)*sb) of each block, sb = ceil(w /
    K); the (max, count) of the lanes to the right (pass A) and to the left
    (pass B) folded in, and the running sums of the runs that cross from
    one lane's rows into the next's carried over (passes B and C), as the
    kernel's shuffles carry them."""
    L = x.shape[0]
    Lout = L - w + 1
    nb = -(-L // w)
    sb = -(-w // K)
    dx = np.zeros(L, np.float32)
    for m0 in range(0, nb, tile):
        m1 = min(nb, m0 + tile)
        # per lane: cur and nxt slots (4 fields) for its sb rows, dv
        cur = np.zeros((K, sb, 4))
        nxt = np.zeros((K, sb, 4))
        dv = np.zeros((K, sb))
        first = True
        for mb in range(max(m0 - 1, 0), m1):
            base, nb1 = mb * w, (mb + 1) * w
            nrow = min(w, L - base)
            nnext = min(w, L - nb1) if nb1 < L else 0
            own = mb >= m0
            rng = [(k * sb, min((k + 1) * sb, nrow)) for k in range(K)]
            nrng = [(k * sb, min((k + 1) * sb, nnext)) for k in range(K)]
            if m0 == 0 and first:
                cur[:, :, 2] = 0.0
            # fetch
            for k in range(K):
                a0, a1 = rng[k]
                for r in range(a0, a1):
                    if first:
                        cur[k, r - a0, 3] = x[base + r]
                    if base + r < Lout:
                        dv[k, r - a0] = dy[base + r]
                n0, n1 = nrng[k]
                for q in range(n0, n1):
                    nxt[k, q - n0, 3] = x[nb1 + q]
            first = False
            # A: local suffix max/count, then the carry from the right
            agg = []
            for k in range(K):
                a0, a1 = rng[k]
                S, c = -math.inf, 0
                for r in range(a1 - 1, a0 - 1, -1):
                    v = cur[k, r - a0, 3]
                    if v > S:
                        S, c = v, 1
                    elif v == S:
                        c += 1
                    cur[k, r - a0, 0], cur[k, r - a0, 1] = S, c
                agg.append((S, c))
            for k in range(K):
                carry = (-math.inf, 0)
                for j in range(K - 1, k, -1):
                    carry = _comb_max(carry, agg[j])
                a0, a1 = rng[k]
                for r in range(a0, a1):
                    Sl, cl = cur[k, r - a0, 0], cur[k, r - a0, 1]
                    S = max(Sl, carry[0])
                    cur[k, r - a0, 0] = S
                    cur[k, r - a0, 1] = (cl if Sl == S else 0) + (
                        carry[1] if carry[0] == S else 0)
            # B: prefix max/count of the next block: aggregates, carries
            pagg = []
            for k in range(K):
                n0, n1 = nrng[k]
                P, c = -math.inf, 0
                for q in range(n0, n1):
                    P, c = _comb_max((P, c), (nxt[k, q - n0, 3], 1))
                pagg.append((P, c))
            pcar = []
            for k in range(K):
                carry = (-math.inf, 0)
                for j in range(k):
                    carry = _comb_max(carry, pagg[j])
                pcar.append(carry)
            # B: the windows of block mb
            tails, wholes, conns, firsts = [], [], [], []
            send = []  # (P, b) for offset k*sb - 1, from lane k to lane k-1
            for k in range(K):
                a0, a1 = rng[k]
                P, cP = pcar[k]
                R, Sp, fr = 0.0, None, a1
                whole = True
                b0 = (-math.inf, 0.0)
                for r in range(a0, a1):
                    i = base + r
                    S, cS, pc, xi = cur[k, r - a0]
                    if r > a0:
                        q = r - 1
                        n0 = nrng[k][0]
                        if q < nrng[k][1]:
                            P, cP = _comb_max((P, cP), (nxt[k, q - n0, 3], 1))
                    a = b = 0.0
                    if i < Lout:
                        y = S if r == 0 else max(S, P)
                        cnt = (cS if S == y else 0) + (cP if r > 0 and P == y
                                                       else 0)
                        d = _f32(np.float32(dv[k, r - a0])
                                 / np.float32(max(cnt, 1)))
                        a = d if S == y else 0.0
                        b = d if r > 0 and P == y else 0.0
                    if r > a0 and S == Sp:
                        R = _f32(R + a)
                    else:
                        if r > a0:
                            if whole:
                                fr = r
                            whole = False
                        R = a
                    Sp = S
                    dv[k, r - a0] = _f32(pc + (R if xi == S else 0.0))
                    if r > 0:
                        q = r - 1
                        if r == a0:  # offset a0 - 1 is lane k-1's
                            b0 = (P, b)
                        else:
                            nxt[k, q - nrng[k][0], 0] = P
                            nxt[k, q - nrng[k][0], 1] = b
                tails.append(R if a1 > a0 else 0.0)
                wholes.append(whole)
                firsts.append(fr)
                send.append(b0)
            # the carries of R: lane k's first run continues lane k-1's last
            cin = [0.0] * K
            for k in range(1, K):
                a0, a1 = rng[k]
                if a1 <= a0 or rng[k - 1][1] <= rng[k - 1][0]:
                    continue
                Sprev = cur[k - 1, rng[k - 1][1] - 1 - rng[k - 1][0], 0]
                if cur[k, 0, 0] == Sprev:
                    cin[k] = _f32(tails[k - 1]
                                  + (cin[k - 1] if wholes[k - 1] else 0.0))
            for k in range(K):
                a0, a1 = rng[k]
                for r in range(a0, a1):
                    S, _, _, xi = cur[k, r - a0]
                    v = dv[k, r - a0]
                    if r < firsts[k] and xi == S:
                        v = _f32(v + cin[k])
                    if own:
                        dx[base + r] = np.float32(v)
            # C: backward over the next block
            if mb + 1 < m1 and nb1 < L:
                qtop = min(w - 1, L - 1 - nb1)
                for k in range(1, K):  # lane k's window at k*sb, for k-1
                    q = k * sb - 1
                    n0, n1 = nrng[k - 1]
                    if n0 <= q < n1 and rng[k][1] > rng[k][0]:
                        nxt[k - 1, q - n0, 0], nxt[k - 1, q - n0, 1] = send[k]
                heads, whs, lrs = [], [], []
                for k in range(K):
                    n0, n1 = nrng[k]
                    hi = min(n1, qtop + 1)
                    Q, Pn, whole, lr = 0.0, None, True, n0
                    for q in range(hi - 1, n0 - 1, -1):
                        if q == w - 1:
                            nxt[k, q - n0, 2] = 0.0
                            Pn = None
                            continue
                        P, b, _, xq = nxt[k, q - n0]
                        if Pn is not None and P == Pn:
                            Q = _f32(Q + b)
                        else:
                            if Pn is not None and whole:
                                lr = q + 1
                                whole = False
                            Q = b
                        Pn = P
                        nxt[k, q - n0, 2] = Q if xq == P else 0.0
                    heads.append(Q)
                    whs.append(whole)
                    lrs.append(lr)
                cin2 = [0.0] * K
                for k in range(K - 2, -1, -1):
                    n0, n1 = nrng[k]
                    hi = min(n1, qtop + 1)
                    m0n, m1n = nrng[k + 1][0], min(nrng[k + 1][1], qtop + 1)
                    if hi <= n0 or m1n <= m0n or m0n == w - 1:
                        continue
                    if hi - 1 == w - 1:
                        continue
                    if nxt[k, hi - 1 - n0, 0] == nxt[k + 1, 0, 0]:
                        cin2[k] = _f32(heads[k + 1]
                                       + (cin2[k + 1] if whs[k + 1] else 0.0))
                for k in range(K):
                    n0, n1 = nrng[k]
                    hi = min(n1, qtop + 1)
                    for q in range(lrs[k], hi):
                        if q == w - 1:
                            continue
                        P, _, pc, xq = nxt[k, q - n0]
                        if xq == P:
                            nxt[k, q - n0, 2] = _f32(pc + cin2[k])
            cur, nxt = nxt, cur
    return dx


def _runs(x, dy, w, tile, lanes):
    """(B, L, C) through ``max_pool_bwd_runs`` channel by channel."""
    out = np.zeros(x.shape, np.float32)
    for b in range(x.shape[0]):
        for c in range(x.shape[2]):
            out[b, :, c] = max_pool_bwd_runs(x[b, :, c], dy[b, :, c], w, tile,
                                             lanes)
    return out


def _check(x, dy, w, tile, lanes=1):
    xt = torch.from_numpy(x)
    y = tsp.sliding_pool_plain(xt, window=w, op="max")
    want = tsp.max_pool_bwd_plain(xt, y, torch.from_numpy(dy),
                                  window=w).numpy()
    got = _runs(x, dy, w, tile, lanes)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.sum(axis=1),
                               dy.sum(axis=1, dtype=np.float64), rtol=1e-5,
                               atol=1e-5 * max(1, dy.shape[1]))


@st.composite
def _case(draw):
    L = draw(st.integers(1, 40))
    w = draw(st.sampled_from(sorted({min(2, L), L, L // 2 + 1,
                                     draw(st.integers(1, L))})))
    C = draw(st.integers(1, 3))
    kind = draw(st.sampled_from(["ints", "relu", "zeros", "normal"]))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    if kind == "ints":
        x = rng.integers(-2, 3, size=(1, L, C)).astype(np.float32)
    elif kind == "relu":
        x = np.maximum(rng.normal(size=(1, L, C)), 0).astype(np.float32)
    elif kind == "zeros":
        x = np.zeros((1, L, C), np.float32)
    else:
        x = rng.normal(size=(1, L, C)).astype(np.float32)
    dy = rng.normal(size=(1, L - w + 1, C)).astype(np.float32)
    tile = draw(st.integers(1, 4))
    lanes = draw(st.sampled_from([1, 2, 4, 8, 32]))
    return x, dy, w, tile, lanes


@settings(max_examples=150, deadline=None)
@given(_case())
def test_runs_match_plain_at_ties(case):
    """Random L, w (1, 2, L, > L / 2 or any), tile, lanes, and ties."""
    _check(*case)


@pytest.mark.parametrize("tile,lanes", [(1, 1), (2, 1), (3, 1), (64, 1),
                                        (1, 2), (1, 4), (1, 32)])
@pytest.mark.parametrize("L,w", [(6, 3), (7, 3), (16, 4), (17, 4), (9, 1),
                                 (9, 2), (9, 9), (9, 5), (33, 8), (50, 7)])
@pytest.mark.parametrize("kind", ["ints", "zeros", "relu"])
def test_runs_match_plain(L, w, tile, lanes, kind):
    """Fixed grid of the edges: w = 1, 2, L, > L / 2, L % w != 0; a lane's
    share of a block of one row, several, or none (lanes > w)."""
    rng = np.random.default_rng(L * 100 + w)
    shape = (2, L, 3)
    if kind == "ints":
        x = rng.integers(0, 3, size=shape).astype(np.float32)
    elif kind == "zeros":
        x = np.zeros(shape, np.float32)
    else:
        x = np.maximum(rng.normal(size=shape), 0).astype(np.float32)
    dy = rng.normal(size=(2, L - w + 1, 3)).astype(np.float32)
    _check(x, dy, w, tile, lanes)


def test_runs_split_ties_evenly():
    """x = zeros(6), w = 3, dy = 1: each window splits 1 over its three
    tied rows, so dx = [1/3, 2/3, 1, 1, 2/3, 1/3] (ROADMAP Queue 3)."""
    got = max_pool_bwd_runs(np.zeros(6, np.float32), np.ones(4, np.float32),
                            3, 1)
    np.testing.assert_allclose(got, [1 / 3, 2 / 3, 1, 1, 2 / 3, 1 / 3],
                               rtol=1e-6)
