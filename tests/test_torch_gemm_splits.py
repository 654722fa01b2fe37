"""The launch geometry of the products on ``csrc/gemm_mma.cuh`` (the tiled
GEMM, row 5, and the 2-D weight gradient, row 12), on the CPU, where no
kernel runs: ``kernels/gemm_plan.py``'s tile, split-K and copy widths, and
a plain-torch transcription of the kernels' summation order held to the
plain versions.

The transcription: each split sums its chunks of ``tile.bk`` reduction
elements one after another in float32, the splits' partials are added in
split order, and the result is cast once, as ``reduce_splits_to`` does.
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, gemm_plan as gp  # noqa: E402
from repro_torch.kernels import im2col_gemm as ig  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as sb  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
TOL = dict(rtol=3e-4, atol=3e-4)  # float32 sums in another order
# (what, M, N, K, dtype): row 5 on the columns PERF.md times it at, row 12
# as the product over the output positions at its timed shapes
TABLE = [
    ("row 5 patch column", 11520, 1152, 588, BF16),
    ("row 5 patch column", 11520, 1152, 588, F32),
    ("row 5 fig1 k31 column", 9604, 32, 30752, F32),
    ("row 5 1-D K65 column", 16320, 32, 2080, F32),
    ("row 5 fig1 k3 column", 15876, 32, 288, F32),
    ("row 12 patch", 588, 1152, 11520, BF16),
    ("row 12 patch", 588, 1152, 11520, F32),
    ("row 12 fig1 k31", 30752, 32, 9604, F32),
    ("row 12 fig2 k17", 9248, 32, 6400, F32),
    ("row 12 fig1 k3", 288, 32, 15876, F32),
]
# ragged edges: nothing a multiple of a tile, N = 1, M < 16, one chunk,
# a long reduction on few tiles
EDGES = [(1, 1, 1), (15, 1, 588), (129, 33, 31), (5, 32, 100_003),
         (200_001, 1200, 17), (588, 70, 2 * 44 * 44), (37, 1152, 33)]
SMS = (build.DEFAULT_SMS, 114, 66, 8, 1)


def _check_plan(p, M, N, K, dtype, sms):
    assert p.tile is gp.pick_tile(N, dtype)
    assert p.tiles == math.ceil(M / p.tile.bm) * math.ceil(N / p.tile.bn)
    assert p.chunks == math.ceil(K / p.tile.bk)
    # the splits cover the chunks exactly, each holding at least one
    assert p.splits >= 1 and p.per >= 1
    assert (p.splits - 1) * p.per < p.chunks <= p.splits * p.per
    ranges = [p.split_range(s) for s in range(p.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] >= K > ranges[-1][0]
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    fill = p.tile.blocks_per_sm * sms
    if p.tiles >= fill:
        assert p.splits == 1  # the blocks alone fill the card
    else:  # no second, part-filled round of blocks
        assert p.splits == 1 or p.splits * p.tiles <= fill
        assert p.splits == 1 or p.per >= gp.MIN_SPLIT_CHUNKS


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("what,M,N,K,dtype", TABLE,
                         ids=[f"{t[0]} {t[4]}" for t in TABLE])
def test_plan_at_the_timed_shapes(what, M, N, K, dtype, sms):
    _check_plan(gp.gemm_plan(M, N, K, dtype, sms), M, N, K, dtype, sms)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("M,N,K", EDGES)
def test_plan_at_ragged_edges(M, N, K, dtype, sms):
    _check_plan(gp.gemm_plan(M, N, K, dtype, sms), M, N, K, dtype, sms)


def test_plan_at_the_h100():
    """On 132 SMs: row 5's patch column fills the card with its tiles (one
    split); row 12's products and row 5's long fig1 column split."""
    def plan(M, N, K, dtype):
        return gp.gemm_plan(M, N, K, dtype, 132)

    assert plan(11520, 1152, 588, BF16).splits == 1
    assert plan(11520, 1152, 588, F32).splits == 1
    assert plan(588, 1152, 11520, BF16).splits == 5
    assert plan(588, 1152, 11520, F32).splits == 5
    assert plan(30752, 32, 9604, F32).splits == 3
    assert plan(9604, 32, 30752, F32).tile is gp.TILES["narrow"]
    assert plan(9604, 32, 30752, F32).splits == 10


def test_plan_follows_the_sm_count():
    """The split count comes from the SM count passed in; the default is
    ``build.DEFAULT_SMS``, the count the wrappers use for a tensor on no
    card."""
    M, N, K = 588, 1152, 11520
    assert gp.gemm_plan(M, N, K, BF16) == gp.gemm_plan(M, N, K, BF16,
                                                       build.DEFAULT_SMS)
    splits = [gp.gemm_plan(M, N, K, BF16, s).splits for s in (132, 66, 8)]
    assert splits == sorted(splits, reverse=True) and len(set(splits)) == 3
    assert gp.gemm_plan(M, N, K, BF16, 1).splits == 1  # 45 tiles fill it


def test_sources_hold_no_sm_count():
    """No new kernel source or the plan holds the H100's 132; the old
    split rule of row 12 is gone."""
    kdir = build.CSRC.parent
    for path in (kdir / "gemm_plan.py", build.CSRC / "gemm_mma.cuh",
                 build.CSRC / "sliding_conv2d_bwd.cu",
                 build.CSRC / "im2col_gemm.cu"):
        text = path.read_text()
        assert not re.search(r"\b132\b", text), path.name
    text = (build.CSRC / "sliding_conv2d_bwd.cu").read_text()
    assert "MIN_BLOCKS" not in text and "conv2d_bwd_dw_splits" not in text


@pytest.mark.parametrize("elem,ptrs,strides,want", [
    (2, [0], [588], 8),                  # row 5's patch column in bf16
    (2, [0], [1152], 16),                # its B
    (4, [0], [588], 16),                 # the column in f32
    (2, [0], [42, 1008, 42], 4),         # row 12's patch runs in bf16
    (4, [0], [42, 1008, 42], 8),         # ... in f32
    (2, [0], [37 * 3, 41 * 37, 37], 2),  # odd runs: plain loads
    (4, [0], [37 * 3, 41 * 37, 37], 4),
    (4, [0], [32 * 31, 128 * 32, 32], 16),  # fig1 k31
    (2, [6], [1152], 2),                 # a pointer 2 bytes past 16
    (2, [4], [1152], 4),
    (4, [8], [32], 8),
])
def test_copy_bytes(elem, ptrs, strides, want):
    assert gp.copy_bytes(elem, ptrs, strides) == want


def split_k(a, b, plan):
    """The kernels' order: float32 sums chunk by chunk within a split, the
    splits added in split order."""
    K = a.shape[1]
    out = None
    for s in range(plan.splits):
        lo, hi = plan.split_range(s)
        part = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
        for c0 in range(lo, min(hi, K), plan.tile.bk):
            c1 = min(c0 + plan.tile.bk, K)
            part = part + a[:, c0:c1].float() @ b[c0:c1].float()
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("M,N,K,sms", [(200, 70, 90, 132), (33, 1, 517, 8),
                                       (129, 32, 4000, 132),
                                       (300, 1152, 588, 132)])
def test_split_order_matches_matmul_plain(M, N, K, sms, dtype):
    rng = np.random.default_rng(M + N + K)
    a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dtype)
    b = torch.from_numpy((rng.normal(size=(K, N)) / np.sqrt(K)).astype(
        np.float32)).to(dtype)
    plan = gp.gemm_plan(M, N, K, dtype, sms)
    got = split_k(a, b, plan)
    want = ig.matmul_plain(a, b)
    if dtype == F32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * want.abs().max().item())
    else:  # one rounding to bf16 from the same float32 value, near enough
        torch.testing.assert_close(got.to(dtype).float(), want.float(),
                                   rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,H,W,Cin,Cout,k,stride,sms", [
    (2, 56, 56, 3, 1152, 14, (14, 14), 132),  # the patch embedding's shape
    (1, 40, 40, 32, 32, 31, (1, 1), 132),     # fig1-like, Cout 32
    (3, 41, 47, 37, 70, 5, (2, 1), 8),
    (2, 20, 23, 5, 1, 1, (1, 1), 132),
])
def test_split_order_matches_conv2d_bwd_dw_plain(B, H, W, Cin, Cout, k,
                                                 stride, sms, dtype):
    """dw as the product over output positions, A the columns' transpose
    ((i, j, c) rows), db as the column sums of dz in the same splits."""
    rng = np.random.default_rng(Cin + Cout + k)
    x = torch.from_numpy(rng.normal(size=(B, H, W, Cin)).astype(
        np.float32)).to(dtype)
    oh, ow = (H - k) // stride[0] + 1, (W - k) // stride[1] + 1
    dz = torch.from_numpy(rng.normal(size=(B, oh, ow, Cout)).astype(
        np.float32)).to(dtype)
    a = ig.columns_2d(x, k, k, stride).T  # (k*k*Cin, B*oh*ow)
    g = dz.reshape(-1, Cout)
    plan = gp.gemm_plan(k * k * Cin, Cout, g.shape[0], dtype, sms)
    dw = split_k(a, g, plan).reshape(k, k, Cin, Cout)
    db = split_k(torch.ones((1, g.shape[0]), dtype=dtype), g, plan)[0]
    want_dw, want_db = sb.conv2d_bwd_dw_plain(x, dz, (k, k), stride=stride,
                                              has_bias=True)
    for got, want in ((dw, want_dw), (db, want_db)):
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale)
