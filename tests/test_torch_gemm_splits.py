"""The launch geometry of the products on ``csrc/gemm_mma.cuh`` (the tiled
GEMM, row 5, the fused 1-D and 2-D im2col convs, rows 6 and 7, the weight
gradients, 1-D and 2-D, rows 10 and 12, and the sliding convs: 1-D, fp
and int8, rows 1 and 13, and 2-D, fp and int8, rows 4 and 14), on the
CPU, where no kernel runs:
``kernels/gemm_plan.py``'s tile, split-K and copy widths, the conv's
gather of x transcribed, and a plain-torch transcription of the kernels'
summation order held to the plain versions.

The transcription: each split sums its chunks of ``tile.bk`` reduction
elements one after another in float32 (exactly, for int8), the splits'
partials are added in split order, and the epilogue (a cast; for the
convs bias, activation and the cast, or dequant and requant) runs once
on the sum, as ``reduce_splits`` does.
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, gemm_plan as gp  # noqa: E402
from repro_torch.kernels import im2col_gemm as ig  # noqa: E402
from repro_torch.kernels import sliding_conv1d as s1  # noqa: E402
from repro_torch.kernels import sliding_conv2d as s2  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as sb  # noqa: E402
from repro_torch.kernels import sliding_conv_quant as sq  # noqa: E402
from repro_torch.kernels.sliding_conv1d import apply_activation  # noqa: E402
from repro_torch.quant import qconv  # noqa: E402

F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8
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
    else:
        assert p.splits == 1 or p.per >= gp.MIN_SPLIT_CHUNKS
        if p.splits * p.tiles > fill:
            # a second round of blocks only where one split's round puts
            # more tiles than SMs on the card, and the split gives the
            # busiest SM fewer chunks than that round does
            def most(s, per):
                return math.ceil(s * p.tiles / sms) * per

            assert sms < p.tiles < fill and fill // p.tiles == 1
            assert dtype == F32 and p.splits * p.tiles <= 2 * fill
            assert most(p.splits, p.per) < most(1, p.chunks)


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


# the splits of every timed shape of rows 1, 4, 5, 6, 7, 12 and 14 on an
# H100, as before the balance rule for one-split rounds of more tiles than
# SMs (row 10's conv2): (M, N, K, dtype) -> splits
TIMED_SPLITS = {
    (11520, 1152, 588, BF16): 1, (11520, 1152, 588, F32): 1,  # row 5
    (9604, 32, 30752, F32): 10, (16320, 32, 2080, F32): 6,
    (15876, 32, 288, F32): 2,
    (588, 1152, 11520, BF16): 5, (588, 1152, 11520, F32): 5,  # row 12
    (30752, 32, 9604, F32): 3, (9248, 32, 6400, F32): 10,
    (288, 32, 15876, F32): 111,
    (15376, 32, 800, F32): 6, (12544, 32, 9248, F32): 8,  # row 4
    (8836, 32, 288, F32): 2, (6400, 32, 9248, F32): 15,
    (11520, 1152, 588, I8): 1, (15876, 32, 288, I8): 1,  # row 14
    (9604, 32, 30752, I8): 3, (8836, 32, 288, I8): 1,
    (6400, 32, 9248, I8): 5,
    (3772, 70, 27, F32): 1, (3772, 70, 27, BF16): 1,  # row 7, phase 33
    (3772, 70, 333, F32): 2, (3772, 70, 333, BF16): 1,
    (966, 70, 75, F32): 1, (966, 70, 75, BF16): 1,
    (966, 70, 925, F32): 7, (966, 70, 925, BF16): 3,
    (672, 70, 105, F32): 1, (672, 70, 105, BF16): 1,
    (672, 70, 1295, F32): 9, (672, 70, 1295, BF16): 5,
    (644, 70, 27, F32): 1, (644, 70, 27, BF16): 1,
    (644, 70, 333, F32): 2, (644, 70, 333, BF16): 1,
    (2048, 1024, 240, F32): 1, (2048, 1024, 240, BF16): 1,  # rows 1, 6
    (1024, 1024, 3072, F32): 4, (1024, 1024, 3072, BF16): 4,
    (16368, 32, 544, F32): 4, (16382, 32, 96, F32): 1,
}


@pytest.mark.parametrize("M,N,K,dtype", list(TIMED_SPLITS),
                         ids=[f"{m}x{n}x{k} {d}" for m, n, k, d in
                              TIMED_SPLITS])
def test_timed_plans_keep_their_splits(M, N, K, dtype):
    """The balance rule moves none of rows 1, 4, 5, 6, 7, 12 and 14's
    plans at their timed shapes: their tiles fill the card, or fall under
    its SM count, or split already."""
    assert gp.gemm_plan(M, N, K, dtype, 132).splits == \
        TIMED_SPLITS[(M, N, K, dtype)]


def test_balanced_splits_at_row10_conv2():
    """Row 10's conv2 in float32 (dw 3072 x 1024 over 1024 positions): 192
    tiles on 132 SMs leave 60 SMs two 64-chunk blocks and 72 one, so the
    busiest SM walks 128 chunks unsplit; split 2 ways it holds 3 blocks of
    32 (96), the fewest splits that do best. bfloat16 keeps one split (its
    partials' pass costs more than the chunks spread), and on 8 SMs the
    tiles fill the card and nothing splits."""
    p = gp.gemm_plan(3072, 1024, 1024, F32, 132)
    assert (p.tiles, p.chunks, p.splits, p.per) == (192, 64, 2, 32)
    assert gp.gemm_plan(3072, 1024, 1024, BF16, 132).splits == 1
    assert gp.gemm_plan(3072, 1024, 1024, F32, 8).splits == 1
    assert gp._balanced_splits(192, 64, 132, 264) == 2
    assert gp._balanced_splits(133, 9, 132, 264) == 1  # per >= 8 chunks
    # at most two rounds: 136 tiles (row 1's dx at whisper's conv2 in
    # float32) take 3 splits, not the 24 that would even the SMs best
    assert gp._balanced_splits(136, 192, 132, 264) == 3


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
    split rules of rows 10, 11 and 12 are gone."""
    kdir = build.CSRC.parent
    for path in (kdir / "gemm_plan.py", build.CSRC / "gemm_mma.cuh",
                 build.CSRC / "sliding_conv2d_bwd.cu",
                 build.CSRC / "im2col_gemm.cu",
                 build.CSRC / "sliding_conv2d.cu",
                 build.CSRC / "sliding_conv2d_quant.cu",
                 build.CSRC / "sliding_conv_quant.cu",
                 build.CSRC / "sliding_conv_bwd.cu",
                 build.CSRC / "conv1d_depthwise.cu",
                 build.CSRC / "conv1d_depthwise_quant.cu",
                 build.CSRC / "conv1d_depthwise_bwd.cu"):
        text = path.read_text()
        assert not re.search(r"\b132\b", text), path.name
    for name, gone in (("sliding_conv2d_bwd.cu", "conv2d_bwd_dw_splits"),
                       ("sliding_conv_bwd.cu", "conv1d_bwd_dw_splits"),
                       ("conv1d_depthwise_bwd.cu",
                        "conv1d_depthwise_bwd_dw_splits")):
        text = (build.CSRC / name).read_text()
        assert "MIN_BLOCKS" not in text and gone not in text, name


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


@pytest.mark.parametrize("dtype", [F32, BF16, I8])
@pytest.mark.parametrize("offset", [0, 1])
def test_wrappers_launch_geometry(dtype, offset):
    """Each product wrapper's launch geometry (``gemm_plan.launch`` on its
    operands, here CPU tensors, which take an H100's SM count): the plan
    for its (M, N, K), x's copy width from its strides and pointer, w's
    from Cout, and a workspace of splits·M·N partials (int32 for int8 x)
    exactly when the plan splits."""
    def tensor(*shape, off=0):
        n = math.prod(shape)
        return torch.zeros(n + off, dtype=dtype)[off:].view(*shape)

    x1, w1 = tensor(2, 130, 1024, off=offset), tensor(3, 1024, 1024)
    x2, w2 = tensor(2, 40, 44, 6, off=offset), tensor(5, 5, 6, 70)
    lout, (oh, ow) = 64, (18, 20)
    cases = [
        (s1.conv1d_launch(x1, w1, 2, lout), x1, w1, 2 * lout, 3 * 1024,
         gp.conv2d_copy_strides(1, 130, 1024, 3, (1, 2))),
        (ig.conv1d_launch(x1, w1, 2, lout), x1, w1, 2 * lout, 3 * 1024,
         gp.im2col_copy_strides(1, 130, 1024, (1, 2))),
        (s2.product_launch(x2, w2, (2, 2), oh, ow), x2, w2, 2 * oh * ow,
         150, gp.conv2d_copy_strides(40, 44, 6, 5, (2, 2))),
        (ig.conv2d_launch(x2, w2, (2, 2), oh, ow), x2, w2, 2 * oh * ow, 150,
         gp.im2col_copy_strides(40, 44, 6, (2, 2))),
    ]
    for (plan, va, vb, ws), x, w, M, K, strides in cases:
        N = w.shape[-1]
        assert plan == gp.gemm_plan(M, N, K, dtype, build.DEFAULT_SMS)
        assert va == gp.copy_bytes(dtype.itemsize, [x.data_ptr()], strides)
        assert vb == gp.copy_bytes(dtype.itemsize, [w.data_ptr()], [N])
        if plan.splits == 1:
            assert ws is None
        else:
            assert ws.shape == (plan.splits * M * N,)
            assert ws.dtype == (torch.int32 if dtype == I8 else F32)
    # whisper's conv2 cut: 8 tiles, split on an H100
    assert cases[0][0][0].splits > 1
    if offset:
        assert cases[0][0][1] == dtype.itemsize


def split_k(a, b, plan):
    """The kernels' order: float32 sums chunk by chunk within a split, the
    splits added in split order; integer operands sum exactly (int64 here,
    int32 on the card, which the callers keep from overflowing)."""
    K = a.shape[1]
    acc = torch.int64 if not a.dtype.is_floating_point else torch.float32
    out = None
    for s in range(plan.splits):
        lo, hi = plan.split_range(s)
        part = torch.zeros((a.shape[0], b.shape[1]), dtype=acc)
        for c0 in range(lo, min(hi, K), plan.tile.bk):
            c1 = min(c0 + plan.tile.bk, K)
            part = part + a[:, c0:c1].to(acc) @ b[c0:c1].to(acc)
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


# ---------------------------------------------------------------------------
# rows 4 and 14: the 2-D sliding conv as the product over output positions
# ---------------------------------------------------------------------------

# (what, B, H, W, Cin, Cout, k, stride, dtype): the shapes ``chip_smoke.py``
# times rows 4 and 14 at (x's dtype picks the tile: w8a16 runs on x's)
CONV_TABLE = [
    ("row 4 patch", 20, 336, 336, 3, 1152, 14, (14, 14), BF16),
    ("row 4 patch", 20, 336, 336, 3, 1152, 14, (14, 14), F32),
    *[(f"row 4 fig1 k{k}", 1, 128, 128, 32, 32, k, (1, 1), F32)
      for k in (3, 5, 17, 31)],
    *[(f"row 4 fig2 k{k}", 1, 96, 96, 32, 32, k, (1, 1), F32)
      for k in (3, 17)],
    ("row 14 patch w8a8", 20, 336, 336, 3, 1152, 14, (14, 14), I8),
    *[(f"row 14 fig1 k{k} w8a8", 1, 128, 128, 32, 32, k, (1, 1), I8)
      for k in (3, 31)],
    *[(f"row 14 fig2 k{k} w8a8", 1, 96, 96, 32, 32, k, (1, 1), I8)
      for k in (3, 17)],
]
# ragged edges: Cin 37 and 130, Cout 70, 1 and 33, odd H and W, k = 1,
# strides (2, 1) and (3, 2)
CONV_EDGES = [(3, 61, 77, 37, 70, 5, (2, 1)), (3, 41, 47, 37, 70, 1, (1, 1)),
              (3, 41, 47, 130, 70, 20, (3, 2)), (1, 9, 9, 3, 1, 3, (3, 2)),
              (2, 20, 23, 5, 33, 1, (1, 1))]


def _conv_dims(B, H, W, Cin, Cout, k, stride):
    """(M, N, K) of the conv's product, and (oh, ow)."""
    oh, ow = (H - k) // stride[0] + 1, (W - k) // stride[1] + 1
    return (B * oh * ow, Cout, k * k * Cin), (oh, ow)


def _check_conv_plan(B, H, W, Cin, Cout, k, stride, dtype, sms):
    (M, N, K), _ = _conv_dims(B, H, W, Cin, Cout, k, stride)
    p = gp.gemm_plan(M, N, K, dtype, sms)
    _check_plan(p, M, N, K, dtype, sms)
    # x's copies start aligned and stay within one filter row's run
    el = dtype.itemsize
    va = gp.copy_bytes(el, [0], gp.conv2d_copy_strides(H, W, Cin, k, stride))
    assert va >= el and (k * Cin * el) % va == 0 and (W * Cin * el) % va == 0
    return p


@pytest.mark.parametrize("sms", (build.DEFAULT_SMS, 8))
@pytest.mark.parametrize("what,B,H,W,Cin,Cout,k,stride,dtype", CONV_TABLE,
                         ids=[f"{t[0]} {t[8]}" for t in CONV_TABLE])
def test_conv_plan_at_the_timed_shapes(what, B, H, W, Cin, Cout, k, stride,
                                       dtype, sms):
    _check_conv_plan(B, H, W, Cin, Cout, k, stride, dtype, sms)


@pytest.mark.parametrize("sms", (build.DEFAULT_SMS, 8))
@pytest.mark.parametrize("dtype", [F32, BF16, I8])
@pytest.mark.parametrize("B,H,W,Cin,Cout,k,stride", CONV_EDGES)
def test_conv_plan_at_ragged_edges(B, H, W, Cin, Cout, k, stride, dtype, sms):
    _check_conv_plan(B, H, W, Cin, Cout, k, stride, dtype, sms)


def test_conv_plan_at_the_h100():
    """On 132 SMs: the patch embedding's 810 tiles fill the card (one
    split) on the bf16, float32 and int8 tiles; fig1 and fig2's Cout 32
    take the 128 x 32 float32 tile and split the taps; int8 keeps its 128
    x 128 tile there."""
    def plan(B, H, W, Cin, Cout, k, stride, dtype):
        (M, N, K), _ = _conv_dims(B, H, W, Cin, Cout, k, stride)
        return gp.gemm_plan(M, N, K, dtype, 132)

    patch = (20, 336, 336, 3, 1152, 14, (14, 14))
    assert [(p.tile, p.splits) for p in (plan(*patch, d)
                                        for d in (BF16, F32, I8))] == [
        (gp.TILES["mma"], 1), (gp.TILES["wide"], 1), (gp.TILES["int8"], 1)]
    fig1 = (1, 128, 128, 32, 32, 31, (1, 1))
    assert plan(*fig1, F32).tile is gp.TILES["narrow"]
    assert plan(*fig1, F32).splits == 10  # as row 5 on the same product
    assert plan(*fig1, I8).tile is gp.TILES["int8"]
    assert plan(*fig1, I8).splits == 3
    assert plan(1, 96, 96, 32, 32, 17, (1, 1), F32).splits == 15


@pytest.mark.parametrize("elem,ptr,H,W,Cin,k,stride,want", [
    (2, 0, 336, 336, 3, 14, (14, 14), 4),   # the patch in bf16: 42-value runs
    (4, 0, 336, 336, 3, 14, (14, 14), 8),   # ... in float32
    (1, 0, 336, 336, 3, 14, (14, 14), 2),   # ... int8: 42 bytes, 2-aligned
    (4, 0, 128, 128, 32, 31, (1, 1), 16),   # fig1 float32, Cin 32
    (1, 0, 128, 128, 32, 31, (1, 1), 16),   # fig1 int8
    (2, 0, 61, 77, 37, 5, (2, 1), 2),       # Cin 37: odd runs, plain loads
    (4, 0, 61, 77, 37, 5, (2, 1), 4),
    (1, 0, 41, 47, 37, 1, (1, 1), 1),       # int8 odd runs: byte loads
    (1, 0, 40, 44, 8, 5, (2, 2), 8),
    (1, 0, 40, 44, 4, 5, (2, 2), 4),
    (4, 4, 128, 128, 32, 31, (1, 1), 4),    # x one element off 16 bytes
    (1, 1, 336, 336, 3, 14, (14, 14), 1),
])
def test_conv_copy_bytes(elem, ptr, H, W, Cin, k, stride, want):
    strides = gp.conv2d_copy_strides(H, W, Cin, k, stride)
    assert gp.copy_bytes(elem, [ptr], strides) == want


def fast_div(n, d):
    """gemm_mma.cuh's FastDiv transcribed: n // d by a multiply and a
    shift for 0 <= n < 2^31."""
    if d == 1:
        return n
    lg = (d - 1).bit_length()  # the least l with 2^l >= d
    mul = ((1 << (31 + lg)) + d - 1) // d
    assert mul < 2 ** 32
    return ((n * mul) >> 32) >> (lg - 1)


def gather_offsets(B, H, W, Cin, k, stride, kh=None):
    """ConvPositions transcribed for a kh x k filter (kh = k by default):
    x's flat offset of A[p, k], at(row(p)) + col(k), every divide a
    FastDiv."""
    kh = k if kh is None else kh
    sh, sw = stride
    oh, ow = (H - kh) // sh + 1, (W - k) // sw + 1
    M, K = B * oh * ow, kh * k * Cin
    offs = np.empty((M, K), dtype=np.int64)
    cols = []
    for kk in range(K):
        i = fast_div(kk, k * Cin)
        cols.append(i * W * Cin + (kk - i * k * Cin))
    for p in range(M):
        b = fast_div(p, oh * ow)
        rem = p - b * oh * ow
        oy = fast_div(rem, ow)
        ox = rem - oy * ow
        offs[p] = ((b * H + oy * sh) * W + ox * sw) * Cin + np.array(cols)
    return offs


@pytest.mark.parametrize("B,H,W,Cin,k,stride", [
    (2, 56, 56, 3, 14, (14, 14)), (1, 20, 22, 4, 5, (1, 1)),
    (3, 13, 17, 37, 3, (2, 1)), (2, 9, 11, 5, 1, (3, 2))])
def test_conv_gather_is_the_column_matrix(B, H, W, Cin, k, stride):
    """A[p, k] read through the gather is the im2col matrix: each
    position's filter rows are runs of x."""
    x = torch.arange(B * H * W * Cin, dtype=torch.int64).reshape(B, H, W, Cin)
    got = x.reshape(-1)[torch.from_numpy(gather_offsets(B, H, W, Cin, k,
                                                        stride))]
    assert torch.equal(got, ig.columns_2d(x, k, k, stride))


@pytest.mark.parametrize("d", [1, 2, 3, 24, 42, 98, 126, 576, 992, 1008,
                               9604, 15876, 29791, 65535, 1 << 20, 40_000_001])
def test_fast_div(d):
    """The multiply-shift division at the conv's divisors (positions an
    image, a row; a filter row's run) and beyond, up to 2^31 - 1."""
    rng = np.random.default_rng(d)
    edges = [q * d + e for q in (1, 2, 3, (2 ** 31 - 1) // d)
             for e in (-1, 0, 1) if 0 <= q * d + e < 2 ** 31]
    ns = np.concatenate([np.arange(0, min(4 * d + 5, 5000)), edges,
                         [2 ** 31 - 1], rng.integers(0, 2 ** 31, size=2000)])
    for n in ns.tolist():
        assert fast_div(n, d) == n // d, (n, d)


# (B, H, W, Cin, Cout, k, stride, sms): the patch embedding cut in batch and
# size, a fig1-like Cout 32 filter (splits), ragged channels and strides on
# 8 SMs, k = 1 with Cout 1
CONV_SPLITS = [(2, 56, 56, 3, 1152, 14, (14, 14), 132),
               (1, 30, 30, 32, 32, 21, (1, 1), 132),
               (3, 41, 47, 37, 70, 5, (2, 1), 8),
               (2, 20, 23, 5, 1, 1, (1, 1), 132)]


def _conv_operands(seed, B, H, W, Cin, Cout, k):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, Cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, Cin, Cout)) / np.sqrt(k * k * Cin)).astype(
        np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    return rng, torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)


@pytest.mark.parametrize("act", ["none", "gelu"])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,H,W,Cin,Cout,k,stride,sms", CONV_SPLITS)
def test_split_order_matches_conv2d_sliding_plain(B, H, W, Cin, Cout, k,
                                                  stride, sms, dtype, act):
    """Row 4: the columns (the gather) times the weight as a (K, Cout)
    matrix in the kernel's split order, then bias, activation and one
    cast, with z the post-bias sum: y and z against the plain version."""
    _, x, w, b = _conv_operands(Cin + Cout + k, B, H, W, Cin, Cout, k)
    x, w = x.to(dtype), w.to(dtype)
    (M, N, K), (oh, ow) = _conv_dims(B, H, W, Cin, Cout, k, stride)
    plan = gp.gemm_plan(M, N, K, dtype, sms)
    pre = split_k(ig.columns_2d(x, k, k, stride), w.reshape(K, N), plan) + b
    got_y = apply_activation(pre, act).to(dtype).reshape(B, oh, ow, N)
    got_z = pre.to(dtype).reshape(B, oh, ow, N)
    want_y, want_z = s2.conv2d_sliding_plain(x, w, b, stride=stride,
                                             activation=act, save_preact=True)
    tol = TOL if dtype == F32 else dict(rtol=2 ** -7, atol=1e-5)
    for got, want in ((got_y, want_y), (got_z, want_z)):
        assert got.dtype == dtype
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=tol["rtol"], atol=tol["atol"] * scale)


@pytest.mark.parametrize("mode,x_dtype,out", [
    ("w8a8", I8, "f32"), ("w8a8", I8, "bf16"), ("w8a8", I8, "int8"),
    ("w8a16", F32, "f32"), ("w8a16", BF16, "bf16"), ("w8a16", BF16, "int8")])
@pytest.mark.parametrize("B,H,W,Cin,Cout,k,stride,sms", CONV_SPLITS)
def test_split_order_matches_conv2d_quant_plain(B, H, W, Cin, Cout, k,
                                                stride, sms, mode, x_dtype,
                                                out):
    """Row 14: w8a8's int8 columns times the codes summed exactly (int32
    partials on the card) then the float32 dequant epilogue: equal to the
    plain version, codes and all; w8a16's codes widened to x's type and
    summed in float32: float outputs within 1e-5 of max |y|, bf16 ones
    within a bf16 step, requantized codes one apart at most and only at
    ties."""
    rng, xf, wf, b = _conv_operands(Cin + Cout + k + 1, B, H, W, Cin, Cout,
                                    k)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(k, k, Cin, Cout),
                                       dtype=np.int8))
    wsc = torch.from_numpy((rng.uniform(0.5, 1.5, size=Cout)
                            / (73 * np.sqrt(k * k * Cin))).astype(np.float32))
    if mode == "w8a8":
        x = torch.from_numpy(rng.integers(-127, 128, size=(B, H, W, Cin),
                                          dtype=np.int8))
        xs = torch.tensor(1 / 73)
        dq = wsc * xs
    else:
        x, xs, dq = xf.to(x_dtype), None, wsc
    (M, N, K), (oh, ow) = _conv_dims(B, H, W, Cin, Cout, k, stride)
    plan = gp.gemm_plan(M, N, K, x_dtype, sms)
    wk = wq.reshape(K, N) if mode == "w8a8" else wq.to(x_dtype).reshape(K, N)
    acc = split_k(ig.columns_2d(x, k, k, stride), wk, plan)
    args = dict(x_scale=xs, mode=mode, stride=stride, activation="silu")
    y32 = sq.conv2d_quant_plain(x, wq, wsc, b, **args)
    os = (y32.abs().max() * 0.8 / 127).reshape(()) if out == "int8" else None
    odt = BF16 if out == "bf16" else F32
    got = qconv._epilogue(acc.float() * dq, b, "silu", os, odt).reshape(
        B, oh, ow, N)
    want = sq.conv2d_quant_plain(x, wq, wsc, b, out_scale=os, out_dtype=odt,
                                 **args)
    assert got.dtype == want.dtype
    if mode == "w8a8":
        assert torch.equal(got, want)
    elif out == "int8":
        diff = (got.int() - want.int()).abs()
        pre = (y32 / os).reshape(-1)[diff.reshape(-1) > 0]
        assert diff.max().item() <= 1
        assert ((pre - pre.round()).abs() - 0.5).abs().max().item() < 1e-3 \
            if pre.numel() else True
    else:
        scale = max(1.0, want.float().abs().max().item())
        tol = 1e-5 if out == "f32" else 2 ** -7
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=1e-5 * scale)


def test_row4_and_row14_sources_are_on_the_product_loop():
    """Rows 4 and 14 include gemm_mma.cuh; the CUDA-core row tiling and
    the __dp4a kernel are gone."""
    assert not (build.CSRC / "conv2d_rows.cuh").exists()
    for name in ("sliding_conv2d.cu", "sliding_conv2d_quant.cu"):
        text = (build.CSRC / name).read_text()
        assert '#include "gemm_mma.cuh"' in text
        for gone in ("conv2d_rows.cuh", "__dp4a", "Tiling", "choose_tiling"):
            assert gone not in text, (name, gone)


# ---------------------------------------------------------------------------
# row 7: the fused 2-D im2col conv on the same loop, its column tap by tap
# ---------------------------------------------------------------------------

# (what, B, H, W, Cin, Cout, kh, kw, stride, dtype, va): phase 35's 2-D
# shapes and phase 33's edges (Cin 3 and 37, strides up to 3 and (2, 3)),
# with x's copy width: one tap's Cin channels at most
IM2COL_TABLE = [
    ("patch", 20, 336, 336, 3, 1152, 14, 14, (14, 14), BF16, 2),
    ("patch", 20, 336, 336, 3, 1152, 14, 14, (14, 14), F32, 4),
    *[(f"fig1 k{k}", 1, 128, 128, 32, 32, k, k, (1, 1), F32, 16)
      for k in (3, 5, 17, 31)],
    *[(f"fig2 k{k}", 1, 96, 96, 32, 32, k, k, (1, 1), F32, 16)
      for k in (3, 17)],
    *[(f"phase 33 {kh}x{kw} s{st} Cin {cin}", 2, kh + 40, kw + 45, cin, 70,
       kh, kw, st, dt, cin * dt.itemsize & -(cin * dt.itemsize))
      for kh, kw, st in ((3, 3, (1, 1)), (5, 5, (2, 2)), (7, 5, (2, 3)),
                         (3, 3, (3, 2)))
      for cin in (3, 37) for dt in (F32, BF16)],
]


@pytest.mark.parametrize("sms", (build.DEFAULT_SMS, 8))
@pytest.mark.parametrize(
    "what,B,H,W,Cin,Cout,kh,kw,stride,dtype,va", IM2COL_TABLE,
    ids=[f"{t[0]} {t[9]}" for t in IM2COL_TABLE])
def test_im2col_plan_and_copy_widths(what, B, H, W, Cin, Cout, kh, kw, stride,
                                     dtype, va, sms):
    """Row 7's plan is gemm_plan's for its product (positions by kh·kw·Cin
    taps by Cout) and x's copies are as wide as one tap's Cin channels
    allow: patch bf16 2 bytes, patch f32 4, fig1 and fig2 16, Cin 37 f32
    4, so that no copy crosses from one tap into the next."""
    oh, ow = (H - kh) // stride[0] + 1, (W - kw) // stride[1] + 1
    M, K = B * oh * ow, kh * kw * Cin
    _check_plan(gp.gemm_plan(M, Cout, K, dtype, sms), M, Cout, K, dtype, sms)
    el = dtype.itemsize
    got = gp.copy_bytes(el, [0], gp.im2col_copy_strides(H, W, Cin, stride))
    assert got == va and (Cin * el) % got == 0


def test_im2col_copy_widths_follow_the_pointer():
    """An x whose storage starts off 16 bytes copies narrower, as row 4's."""
    strides = gp.im2col_copy_strides(128, 128, 32, (1, 1))
    assert gp.copy_bytes(4, [4], strides) == 4
    assert gp.copy_bytes(4, [8], strides) == 8
    assert gp.copy_bytes(2, [2], gp.im2col_copy_strides(56, 56, 4, (2, 2))) \
        == 2


def tap_offsets(B, H, W, Cin, kh, kw, stride):
    """Row 7's gather transcribed (``TapColumns``): x's flat offset of A[p,
    k], ConvPositions' row(p) times Cin plus col(k), k = t·Cin + c with
    tap t = i·kw + j, every divide a FastDiv."""
    sh, sw = stride
    oh, ow = (H - kh) // sh + 1, (W - kw) // sw + 1
    cols = []
    for k in range(kh * kw * Cin):
        t = fast_div(k, Cin)
        c = k - t * Cin
        i = fast_div(t, kw)
        j = t - i * kw
        cols.append((i * W + j) * Cin + c)
    offs = np.empty((B * oh * ow, kh * kw * Cin), dtype=np.int64)
    for p in range(B * oh * ow):
        b = fast_div(p, oh * ow)
        rem = p - b * oh * ow
        oy = fast_div(rem, ow)
        ox = rem - oy * ow
        offs[p] = ((b * H + oy * sh) * W + ox * sw) * Cin + np.array(cols)
    return offs


@pytest.mark.parametrize("B,H,W,Cin,kh,kw,stride", [
    (2, 56, 56, 3, 14, 14, (14, 14)), (1, 20, 22, 4, 5, 5, (1, 1)),
    (2, 13, 17, 37, 7, 5, (2, 3)), (2, 9, 11, 5, 1, 1, (3, 2)),
    (1, 12, 14, 3, 3, 3, (3, 2))])
def test_im2col_gather_is_the_column_matrix(B, H, W, Cin, kh, kw, stride):
    """A[p, k] read through row 7's tap-by-tap gather is the im2col
    matrix, and each copy (va / element bytes channels, va from the
    strides) stays within one tap."""
    x = torch.arange(B * H * W * Cin, dtype=torch.int64).reshape(B, H, W, Cin)
    offs = tap_offsets(B, H, W, Cin, kh, kw, stride)
    got = x.reshape(-1)[torch.from_numpy(offs)]
    assert torch.equal(got, ig.columns_2d(x, kh, kw, stride))
    for el in (2, 4):
        n = gp.copy_bytes(el, [0], gp.im2col_copy_strides(H, W, Cin,
                                                          stride)) // el
        # a copy's n values are contiguous in x: k .. k + n - 1 of one tap
        runs = offs[:, ::n]
        for d in range(1, n):
            assert np.array_equal(offs[:, d::n], runs + d)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,H,W,Cin,Cout,kh,kw,stride,sms", [
    (2, 56, 56, 3, 1152, 14, 14, (14, 14), 132),  # the patch embedding cut
    (1, 40, 40, 32, 32, 31, 31, (1, 1), 132),     # fig1-like, Cout 32, split
    (2, 45, 50, 37, 70, 7, 5, (2, 3), 8),
    (2, 20, 23, 5, 1, 1, 1, (1, 1), 132),
])
def test_split_order_matches_conv2d_im2col_fused_plain(B, H, W, Cin, Cout,
                                                       kh, kw, stride, sms,
                                                       dtype):
    """Row 7: the columns (the tap gather) times the (kh·kw·Cin, Cout)
    weights in the kernel's split order, float32 partials added in split
    order, one cast: against the plain version, float32 within 1e-5 of
    max |y|, bf16 one rounding from the same float32 value."""
    rng = np.random.default_rng(Cin + Cout + kh)
    x = torch.from_numpy(rng.normal(size=(B, H, W, Cin)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(size=(kh, kw, Cin, Cout))
                          / np.sqrt(kh * kw * Cin)).astype(np.float32)).to(
        dtype)
    oh, ow = (H - kh) // stride[0] + 1, (W - kw) // stride[1] + 1
    M, K = B * oh * ow, kh * kw * Cin
    plan = gp.gemm_plan(M, Cout, K, dtype, sms)
    if (kh, sms) == (31, 132):
        assert plan.splits > 1
    cols = x.reshape(-1)[torch.from_numpy(tap_offsets(B, H, W, Cin, kh, kw,
                                                       stride))]
    got = split_k(cols, w.reshape(K, Cout), plan).to(dtype).reshape(
        B, oh, ow, Cout)
    want = ig.conv2d_im2col_fused_plain(x, w, stride=stride)
    assert got.dtype == want.dtype == dtype
    if dtype == F32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * want.abs().max().item())
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-5)


def _c_entry(source, name):
    """The text of C entry ``name`` in ``csrc/<source>``, from its
    signature to the next entry."""
    text = (build.CSRC / source).read_text()
    entry = text[text.index(f'extern "C" int {name}('):]
    return entry[:entry.index('extern "C"', 10)]


def _check_argtypes(entry, argtypes):
    """A C entry's parameters against its wrapper's ctypes list: as many,
    and a pointer (``c_void_p``) exactly where the C parameter is one."""
    params = entry[entry.index("(") + 1 : entry.index(")")].split(",")
    assert len(params) == len(argtypes)
    for prm, t in zip(params, argtypes):
        assert ("*" in prm) == (t is ig.ctypes.c_void_p), prm


def test_row7_source_is_on_the_product_loop():
    """Rows 5, 6 and 7 call gm::gemm (through store_gemm, a Store
    epilogue), the convs with their tap gather; Cols1d, Cols2d, the old
    launch template and gemm_tile.cuh are gone, and nothing includes
    gemm_tile.cuh."""
    text = (build.CSRC / "im2col_gemm.cu").read_text()
    helper = text[text.index("int store_gemm("):text.index('extern "C"')]
    assert "gm::gemm(" in helper and "gm::Store<" in helper
    for name, argtypes in (("im2col_matmul", ig._MM_ARGTYPES),
                           ("im2col_conv1d", ig._1D_ARGTYPES),
                           ("im2col_conv2d", ig._2D_ARGTYPES)):
        entry = _c_entry("im2col_gemm.cu", name)
        assert "store_gemm(" in entry and "launch(" not in entry, name
        assert ("TapColumns" in entry) == (name != "im2col_matmul"), name
        _check_argtypes(entry, argtypes)
    for gone in ("Cols1d", "Cols2d", "gemm_kernel", "GTHREADS"):
        assert gone not in text, gone
    assert not (build.CSRC / "gemm_tile.cuh").exists()
    for path in build.CSRC.iterdir():
        assert "gemm_tile" not in path.read_text(), path.name


def test_row1_source_is_on_the_product_loop():
    """Row 1 is one product on gm::gemm (through bias_act_gemm, row 4's
    BiasAct epilogue) with ConvPositions at H = oh = kh = 1; the 64 x 64
    tile and its halo limit are gone; its ctypes list matches the C
    signature; BiasAct lives in gemm_mma.cuh alone."""
    entry = _c_entry("sliding_conv1d.cu", "sliding_conv1d")
    assert "gm::bias_act_gemm(" in entry
    assert "gm::conv_positions(1, L, Cin, K, 1, stride, 1, Lout)" in entry
    assert "gm::conv_shape_ok(B, 1, L, Cin, Cout, 1, K, 1, stride, 1, Lout)" \
        in entry
    text = (build.CSRC / "sliding_conv1d.cu").read_text()
    assert '#include "gemm_mma.cuh"' in text
    for gone in ("halo_floats", "sliding_conv1d_kernel", "TL =", "227"):
        assert gone not in text, gone
    _check_argtypes(entry, s1._ARGTYPES)
    header = (build.CSRC / "gemm_mma.cuh").read_text()
    helper = header[header.index("int bias_act_gemm("):]
    assert "gemm(" in helper and "BiasAct<" in helper
    assert "struct BiasAct" in header
    assert "struct BiasAct" not in (build.CSRC / "sliding_conv2d.cu"
                                    ).read_text()
    assert "gm::bias_act_gemm(" in _c_entry("sliding_conv2d.cu",
                                            "sliding_conv2d")


# ---------------------------------------------------------------------------
# rows 1 and 6: the 1-D convs on the same loop, H = oh = kh = 1
# ---------------------------------------------------------------------------

# (what, B, L, Cin, Cout, K, stride, dtype, splits on 132 SMs, tile, va):
# whisper's frontend (the main path; f32 and bf16) and phase 35's 1-D
# table, with the plan on an H100 and x's copy width, the same for rows 1
# and 6 at these shapes
CONV1D_TABLE = [
    ("whisper conv1", 4, 514, 80, 1024, 3, 1, F32, 1, "wide", 16),
    ("whisper conv1", 4, 514, 80, 1024, 3, 1, BF16, 1, "mma", 16),
    ("whisper conv2", 4, 514, 1024, 1024, 3, 2, F32, 4, "wide", 16),
    ("whisper conv2", 4, 514, 1024, 1024, 3, 2, BF16, 4, "mma", 16),
    ("table K65", 1, 16384, 32, 32, 65, 1, F32, 6, "narrow", 16),
    ("table K17", 1, 16384, 32, 32, 17, 1, F32, 4, "narrow", 16),
    ("table K3", 1, 16384, 32, 32, 3, 1, F32, 1, "narrow", 16),
]


def _conv1d_dims(B, L, Cin, Cout, K, stride):
    """(M, N, K) of the 1-D conv's product, and Lout."""
    lout = (L - K) // stride + 1
    return (B * lout, Cout, K * Cin), lout


@pytest.mark.parametrize("sms", (build.DEFAULT_SMS, 8))
@pytest.mark.parametrize(
    "what,B,L,Cin,Cout,K,stride,dtype,splits,tile,va", CONV1D_TABLE,
    ids=[f"{t[0]} {t[7]}" for t in CONV1D_TABLE])
def test_conv1d_plans_and_copy_widths(what, B, L, Cin, Cout, K, stride,
                                      dtype, splits, tile, va, sms):
    """Rows 1 and 6 take gemm_plan's plan for their product (positions by
    K·Cin taps by Cout): on an H100 whisper's conv1 fills the card with
    its 128 tiles, conv2 splits its 64 tiles 4 ways, the 1-D table's K=65
    splits 128 tiles 6 ways; on 8 SMs nothing splits. x's copies are 16
    bytes for both gathers: row 1's along a position's whole K·Cin run,
    row 6's within one tap's Cin channels."""
    (M, N, Kr), _ = _conv1d_dims(B, L, Cin, Cout, K, stride)
    p = gp.gemm_plan(M, N, Kr, dtype, sms)
    _check_plan(p, M, N, Kr, dtype, sms)
    assert p.tile is gp.TILES[tile]
    if sms == build.DEFAULT_SMS:
        assert p.splits == splits
    else:
        assert p.splits == 1
    el = dtype.itemsize
    run = gp.copy_bytes(el, [0], gp.conv2d_copy_strides(1, L, Cin, K,
                                                        (1, stride)))
    tap = gp.copy_bytes(el, [0], gp.im2col_copy_strides(1, L, Cin,
                                                        (1, stride)))
    assert run == tap == va


def test_conv1d_plans_at_the_h100():
    """The chunk counts a split walks at whisper's conv2 and the table's
    K=65 on 132 SMs."""
    def plan(B, L, Cin, Cout, K, stride, dtype):
        return gp.gemm_plan(*_conv1d_dims(B, L, Cin, Cout, K, stride)[0],
                            dtype, 132)

    p = plan(4, 514, 1024, 1024, 3, 2, F32)
    assert (p.tiles, p.splits, p.per) == (64, 4, 48)
    p = plan(4, 514, 1024, 1024, 3, 2, BF16)
    assert (p.tiles, p.splits, p.per) == (64, 4, 24)
    p = plan(1, 16384, 32, 32, 65, 1, F32)
    assert (p.tiles, p.splits) == (128, 6)


@pytest.mark.parametrize("elem,ptr,L,Cin,K,stride,run,tap", [
    (4, 0, 301, 37, 3, 1, 4, 4),     # Cin 37: 4-byte copies in f32
    (2, 0, 301, 37, 3, 1, 2, 2),     # ... plain 2-byte loads in bf16
    (2, 0, 300, 37, 4, 2, 4, 2),     # even strides: 4-byte runs, 2-byte taps
    (4, 0, 301, 3, 7, 2, 4, 4),      # Cin 3
    (2, 0, 300, 3, 8, 2, 4, 2),      # Cin 3, 24-value runs, even L
    (2, 0, 514, 80, 3, 1, 16, 16),   # whisper conv1 in bf16
    (4, 4, 514, 80, 3, 1, 4, 4),     # x one element off 16 bytes
    (2, 2, 514, 1024, 3, 2, 2, 2),   # ... in bf16
    (4, 0, 16384, 32, 65, 1, 16, 16),
    (4, 0, 300, 6, 5, 3, 8, 8),      # Cin 6: 8-byte copies in f32
])
def test_conv1d_copy_bytes(elem, ptr, L, Cin, K, stride, run, tap):
    """Row 1's copy width follows its K·Cin runs, row 6's one tap's Cin
    channels; both the pointer's alignment."""
    assert gp.copy_bytes(elem, [ptr], gp.conv2d_copy_strides(
        1, L, Cin, K, (1, stride))) == run
    assert gp.copy_bytes(elem, [ptr], gp.im2col_copy_strides(
        1, L, Cin, (1, stride))) == tap


@pytest.mark.parametrize("B,L,Cin,K,stride", [
    (2, 40, 3, 5, 1), (3, 37, 37, 3, 2), (2, 50, 4, 7, 3), (1, 9, 5, 1, 1),
    (2, 30, 6, 30, 1), (1, 70, 2, 65, 2)])
def test_conv1d_gathers_are_the_column_matrix(B, L, Cin, K, stride):
    """Row 1's gather (ConvPositions at H = oh = kh = 1) and row 6's
    (TapColumns at kh = 1) read the 1-D im2col matrix, ``columns_1d``;
    each copy of row 6 stays within one tap, each of row 1 within its
    position's run."""
    x = torch.arange(B * L * Cin, dtype=torch.int64).reshape(B, L, Cin)
    want = ig.columns_1d(x, K, stride)
    x2 = x.reshape(-1)
    run = gather_offsets(B, 1, L, Cin, K, (1, stride), kh=1)
    tap = tap_offsets(B, 1, L, Cin, 1, K, (1, stride))
    assert torch.equal(x2[torch.from_numpy(run)], want)
    assert torch.equal(x2[torch.from_numpy(tap)], want)
    for el in (2, 4):
        for offs, strides in (
                (run, gp.conv2d_copy_strides(1, L, Cin, K, (1, stride))),
                (tap, gp.im2col_copy_strides(1, L, Cin, (1, stride)))):
            n = gp.copy_bytes(el, [0], strides) // el
            assert (K * Cin) % n == 0
            for d in range(1, n):
                assert np.array_equal(offs[:, d::n], offs[:, ::n] + d)


# (B, L, Cin, Cout, K, stride, sms): whisper's conv2 cut in batch and
# length (4 splits on 132 SMs), the table's K=65 cut (narrow tile,
# splits), ragged channels and strides on 8 SMs, K = 1 with Cout 1
CONV1D_SPLITS = [(2, 130, 1024, 1024, 3, 2, 132),
                 (1, 2000, 32, 32, 65, 1, 132),
                 (3, 301, 37, 70, 7, 3, 8),
                 (2, 50, 5, 1, 1, 1, 132)]


@pytest.mark.parametrize("act", ["none", "gelu", "silu"])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,L,Cin,Cout,K,stride,sms", CONV1D_SPLITS)
def test_split_order_matches_conv1d_sliding_plain(B, L, Cin, Cout, K, stride,
                                                  sms, dtype, act):
    """Row 1: the columns (the gather) times the (K·Cin, Cout) weights in
    the kernel's split order, then bias, activation and one cast, z the
    post-bias sum: y and z against the plain version."""
    rng = np.random.default_rng(Cin + Cout + K)
    x = torch.from_numpy(rng.normal(size=(B, L, Cin)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(size=(K, Cin, Cout))
                          / np.sqrt(K * Cin)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.normal(size=(Cout,)).astype(np.float32))
    (M, N, Kr), lout = _conv1d_dims(B, L, Cin, Cout, K, stride)
    plan = gp.gemm_plan(M, N, Kr, dtype, sms)
    if (Cin, sms) == (1024, 132):
        assert plan.splits > 1
    cols = x.reshape(-1)[torch.from_numpy(gather_offsets(
        B, 1, L, Cin, K, (1, stride), kh=1))]
    pre = split_k(cols, w.reshape(Kr, N), plan) + b
    got_y = apply_activation(pre, act).to(dtype).reshape(B, lout, N)
    got_z = pre.to(dtype).reshape(B, lout, N)
    want_y, want_z = s1.conv1d_sliding_plain(x, w, b, stride=stride,
                                             activation=act, save_preact=True)
    tol = TOL if dtype == F32 else dict(rtol=2 ** -7, atol=1e-5)
    for got, want in ((got_y, want_y), (got_z, want_z)):
        assert got.dtype == dtype
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=tol["rtol"], atol=tol["atol"] * scale)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,L,Cin,Cout,K,stride,sms", CONV1D_SPLITS)
def test_split_order_matches_conv1d_im2col_fused_plain(B, L, Cin, Cout, K,
                                                       stride, sms, dtype):
    """Row 6: the columns (the tap gather) times the weights in the
    kernel's split order, one cast: against the plain version, float32
    within 1e-5 of max |y|, bf16 one rounding from the same float32
    value."""
    rng = np.random.default_rng(Cin + Cout + K + 1)
    x = torch.from_numpy(rng.normal(size=(B, L, Cin)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(size=(K, Cin, Cout))
                          / np.sqrt(K * Cin)).astype(np.float32)).to(dtype)
    (M, N, Kr), lout = _conv1d_dims(B, L, Cin, Cout, K, stride)
    plan = gp.gemm_plan(M, N, Kr, dtype, sms)
    cols = x.reshape(-1)[torch.from_numpy(tap_offsets(B, 1, L, Cin, 1, K,
                                                       (1, stride)))]
    got = split_k(cols, w.reshape(Kr, N), plan).to(dtype).reshape(B, lout, N)
    want = ig.conv1d_im2col_fused_plain(x, w, stride=stride)
    assert got.dtype == want.dtype == dtype
    if dtype == F32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * want.abs().max().item())
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# rows 13 and 10: the int8 1-D conv (ConvPositions at H = oh = kh = 1) and
# the 1-D weight gradient (FilterRuns at kh = 1) on the same loop
# ---------------------------------------------------------------------------

# (what, B, L, Cin, Cout, K, stride, dtype, splits and per on 132 SMs, tile,
# va): whisper's int8 frontend, w8a8 (int8 x) and w8a16 (float32 and
# bfloat16 x, each on its type's tile), with x's copy width
ROW13_TABLE = [
    ("conv1 w8a8", 4, 514, 80, 1024, 3, 1, I8, 1, 4, "int8", 16),
    ("conv1 w8a16", 4, 514, 80, 1024, 3, 1, F32, 1, 15, "wide", 16),
    ("conv1 w8a16", 4, 514, 80, 1024, 3, 1, BF16, 1, 8, "mma", 16),
    ("conv2 w8a8", 4, 514, 1024, 1024, 3, 2, I8, 4, 12, "int8", 16),
    ("conv2 w8a16", 4, 514, 1024, 1024, 3, 2, F32, 4, 48, "wide", 16),
    ("conv2 w8a16", 4, 514, 1024, 1024, 3, 2, BF16, 4, 24, "mma", 16),
]


@pytest.mark.parametrize("sms", (build.DEFAULT_SMS, 8))
@pytest.mark.parametrize(
    "what,B,L,Cin,Cout,K,stride,dtype,splits,per,tile,va", ROW13_TABLE,
    ids=[f"{t[0]} {t[7]}" for t in ROW13_TABLE])
def test_row13_plans_and_copy_widths(what, B, L, Cin, Cout, K, stride, dtype,
                                     splits, per, tile, va, sms):
    """Row 13 takes gemm_plan's plan for x's type (positions by K·Cin taps
    by Cout): on an H100 conv1's 128 tiles of 4 int8 chunks run unsplit,
    conv2's 64 tiles split 4 ways (12 int8 chunks each); on 8 SMs nothing
    splits. x's copies are 16 bytes along a position's whole run, the
    int8 codes too: no channel padding."""
    (M, N, Kr), _ = _conv1d_dims(B, L, Cin, Cout, K, stride)
    p = gp.gemm_plan(M, N, Kr, dtype, sms)
    _check_plan(p, M, N, Kr, dtype, sms)
    assert p.tile is gp.TILES[tile]
    if sms == build.DEFAULT_SMS:
        assert (p.splits, p.per) == (splits, per)
    else:
        assert p.splits == 1
    assert gp.copy_bytes(dtype.itemsize, [0], gp.conv2d_copy_strides(
        1, L, Cin, K, (1, stride))) == va


# (what, B, L, Cin, Cout, K, stride, dtype, splits and per on 132 SMs, tile,
# va): row 10 at whisper's frontend, dw (K·Cin, Cout) over the B·Lout
# positions
ROW10_TABLE = [
    ("conv1", 4, 514, 80, 1024, 3, 1, F32, 16, 8, "wide", 16),
    ("conv1", 4, 514, 80, 1024, 3, 1, BF16, 8, 8, "mma", 16),
    ("conv2", 4, 514, 1024, 1024, 3, 2, F32, 2, 32, "wide", 16),
    ("conv2", 4, 514, 1024, 1024, 3, 2, BF16, 1, 32, "mma", 16),
]


def _dw1d_dims(B, L, Cin, Cout, K, stride):
    """(M, N, K) of the 1-D weight gradient's product, and Lout."""
    lout = (L - K) // stride + 1
    return (K * Cin, Cout, B * lout), lout


@pytest.mark.parametrize("sms", (build.DEFAULT_SMS, 8))
@pytest.mark.parametrize(
    "what,B,L,Cin,Cout,K,stride,dtype,splits,per,tile,va", ROW10_TABLE,
    ids=[f"{t[0]} {t[7]}" for t in ROW10_TABLE])
def test_row10_plans_and_copy_widths(what, B, L, Cin, Cout, K, stride, dtype,
                                     splits, per, tile, va, sms):
    """Row 10 takes gemm_plan's plan for dw (K·Cin, Cout) over the B·Lout
    positions: on an H100 conv1's 16 tiles split 16 ways in float32 (8 in
    bfloat16); conv2's 192 tiles split 2 ways in float32 (the balance
    rule) and run unsplit in bfloat16; on 8 SMs nothing splits.
    x's copies are 16 bytes along a position's K·Cin run, dz's too."""
    (M, N, Kr), _ = _dw1d_dims(B, L, Cin, Cout, K, stride)
    p = gp.gemm_plan(M, N, Kr, dtype, sms)
    _check_plan(p, M, N, Kr, dtype, sms)
    assert p.tile is gp.TILES[tile]
    if sms == build.DEFAULT_SMS:
        assert (p.tiles, p.splits, p.per) == (-(-M // 128) * 8, splits, per)
    else:
        assert p.splits == 1
    el = dtype.itemsize
    assert gp.copy_bytes(el, [0], gp.dw_copy_strides(L, Cin, K, stride)) == va
    assert gp.copy_bytes(el, [0], [Cout]) == 16


@pytest.mark.parametrize("row,elem,ptr,L,Cin,K,stride,want", [
    (13, 1, 0, 203, 37, 3, 1, 1),    # Cin 37 int8: byte loads, no pad
    (13, 1, 0, 203, 80, 5, 2, 16),   # Cin 80 int8
    (13, 1, 0, 204, 37, 20, 2, 2),   # Cin 37, even stride, K, L: 2 bytes
    (13, 1, 1, 514, 80, 3, 1, 1),    # x one code off its alignment
    (13, 1, 2, 514, 80, 3, 1, 2),
    (13, 4, 4, 203, 37, 3, 2, 4),    # w8a16 f32, x one element off
    (13, 2, 0, 203, 37, 7, 2, 2),    # w8a16 bf16, Cin 37
    (10, 4, 0, 203, 37, 3, 1, 4),    # phase 7's edges: Cin 37
    (10, 2, 0, 203, 37, 20, 2, 2),
    (10, 4, 4, 514, 80, 3, 1, 4),    # x one element off
    (10, 2, 2, 514, 1024, 3, 2, 2),
    (10, 2, 0, 514, 1024, 3, 2, 16),
])
def test_row13_and_row10_copy_bytes(row, elem, ptr, L, Cin, K, stride, want):
    """Rows 13 and 10 copy x as wide as its K·Cin runs and its pointer
    allow, down to single int8 codes: the 1-D w8a8 path pads no channel
    and clones no misaligned x."""
    strides = (gp.conv2d_copy_strides(1, L, Cin, K, (1, stride)) if row == 13
               else gp.dw_copy_strides(L, Cin, K, stride))
    assert gp.copy_bytes(elem, [ptr], strides) == want


def filter_run_offsets(B, H, W, Cin, kh, kw, stride):
    """FilterRuns transcribed: x's flat offset of A[m, p] = row(m) +
    col(p), m the flat (i, j, c) filter index, p an output position, the
    position's divides FastDivs."""
    sh, sw = stride
    oh, ow = (H - kh) // sh + 1, (W - kw) // sw + 1
    kwc = kw * Cin
    rows = np.array([(m // kwc) * W * Cin + m % kwc
                     for m in range(kh * kwc)], dtype=np.int64)
    cols = np.empty(B * oh * ow, dtype=np.int64)
    for p in range(B * oh * ow):
        b = fast_div(p, oh * ow)
        rem = p - b * oh * ow
        oy = fast_div(rem, ow)
        ox = rem - oy * ow
        cols[p] = ((b * H + oy * sh) * W + ox * sw) * Cin
    return rows[:, None] + cols[None, :]


@pytest.mark.parametrize("B,H,W,Cin,kh,kw,stride", [
    (2, 1, 40, 3, 1, 5, (1, 1)), (3, 1, 37, 37, 1, 3, (1, 2)),
    (2, 1, 50, 4, 1, 7, (1, 3)), (1, 1, 9, 5, 1, 1, (1, 1)),
    (2, 1, 70, 2, 1, 65, (1, 2)), (2, 13, 17, 37, 3, 5, (2, 3)),
    (2, 56, 56, 3, 14, 14, (14, 14))])
def test_filter_runs_are_the_column_matrix(B, H, W, Cin, kh, kw, stride):
    """A[m, p] read through FilterRuns is the transposed im2col matrix,
    1-D (row 10, H = kh = 1: row(m) = m) and 2-D (row 12), and each copy
    along m (va / element bytes values, va from dw_copy_strides) is
    contiguous in x."""
    x = torch.arange(B * H * W * Cin, dtype=torch.int64).reshape(B, H, W, Cin)
    offs = filter_run_offsets(B, H, W, Cin, kh, kw, stride)
    got = x.reshape(-1)[torch.from_numpy(offs)]
    if H == 1:
        assert np.array_equal(offs[:, :1], np.arange(kw * Cin)[:, None])
        want = ig.columns_1d(x.reshape(B, W, Cin), kw, stride[1]).T
    else:
        want = ig.columns_2d(x, kh, kw, stride).T
    assert torch.equal(got, want)
    for el in (2, 4):
        n = gp.copy_bytes(el, [0], gp.dw_copy_strides(W, Cin, kw,
                                                      stride[1])) // el
        assert (kw * Cin) % n == 0
        for d in range(1, n):
            assert np.array_equal(offs[d::n], offs[::n] + d)


@pytest.mark.parametrize("has_bias", [True, False])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("offset", [0, 1])
def test_dw_launch_geometry(offset, dtype, has_bias):
    """Rows 10 and 12's launch geometry (``sliding_conv_bwd.dw_launch`` on
    CPU tensors, an H100's SM count): the plan for dw over the output
    positions, x's copy width from its filter-row runs and pointer, dz's
    from Cout, and a float32 workspace of splits·(M·N + N) partials with a
    bias, splits·M·N without, exactly when the plan splits."""
    def tensor(*shape, off=0):
        n = math.prod(shape)
        return torch.zeros(n + off, dtype=dtype)[off:].view(*shape)

    x1, dz1 = tensor(2, 514, 80, off=offset), tensor(2, 512, 1024)
    x2, dz2 = tensor(2, 40, 44, 6, off=offset), tensor(2, 18, 20, 70)
    cases = [
        (sb.dw_launch(x1, dz1, 3 * 80, 514, 80, 3, 1, has_bias), x1, dz1,
         3 * 80, gp.dw_copy_strides(514, 80, 3, 1)),
        (sb.dw_launch(x2, dz2, 5 * 5 * 6, 44, 6, 5, 2, has_bias), x2, dz2,
         150, gp.dw_copy_strides(44, 6, 5, 2)),
    ]
    for (plan, va, vb, ws), x, dz, M, strides in cases:
        N = dz.shape[-1]
        K = dz.numel() // N
        assert plan == gp.gemm_plan(M, N, K, dtype, build.DEFAULT_SMS)
        assert va == gp.copy_bytes(dtype.itemsize, [x.data_ptr()], strides)
        assert vb == gp.copy_bytes(dtype.itemsize, [dz.data_ptr()], [N])
        if plan.splits == 1:
            assert ws is None
        else:
            assert ws.dtype == F32
            assert ws.shape == (plan.splits * (M * N + N * has_bias),)
    assert cases[0][0][0].splits > 1  # 16 tiles on 132 SMs
    if offset:
        assert cases[0][0][1] == dtype.itemsize


# (B, L, Cin, Cout, K, stride, sms): row 13 at whisper's conv2 cut in
# length (8 int8 tiles, split on 132 SMs) and conv1 cut (4 chunks, no
# split), phase 11's Cin 37 and 80 with K 7 and 20, K = 1 with Cout 1
ROW13_SPLITS = [(2, 130, 1024, 1024, 3, 2, 132),
                (2, 258, 80, 1024, 3, 1, 132),
                (3, 203, 37, 70, 7, 2, 8),
                (3, 203, 80, 70, 20, 1, 132),
                (2, 50, 5, 1, 1, 1, 132)]


@pytest.mark.parametrize("mode,x_dtype,out", [
    ("w8a8", I8, "f32"), ("w8a8", I8, "bf16"), ("w8a8", I8, "int8"),
    ("w8a16", F32, "f32"), ("w8a16", BF16, "bf16"), ("w8a16", BF16, "int8")])
@pytest.mark.parametrize("B,L,Cin,Cout,K,stride,sms", ROW13_SPLITS)
def test_split_order_matches_conv1d_quant_plain(B, L, Cin, Cout, K, stride,
                                                sms, mode, x_dtype, out):
    """Row 13: w8a8's int8 columns (ConvPositions at H = 1, no channel
    padding) times the codes summed exactly, int32 partials added in split
    order, then the float32 dequant epilogue: equal to the plain version,
    codes and all; w8a16's codes widened to x's type and summed in float32:
    float outputs within 1e-5 of max |y|, bf16 ones within a bf16 step,
    requantized codes one apart at most and only at ties."""
    rng = np.random.default_rng(Cin + Cout + K + 2)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(K, Cin, Cout),
                                       dtype=np.int8))
    wsc = torch.from_numpy((rng.uniform(0.5, 1.5, size=Cout)
                            / (73 * np.sqrt(K * Cin))).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(Cout,)).astype(np.float32))
    if mode == "w8a8":
        x = torch.from_numpy(rng.integers(-127, 128, size=(B, L, Cin),
                                          dtype=np.int8))
        xs = torch.tensor(1 / 73)
        dq = wsc * xs
    else:
        x = torch.from_numpy(rng.normal(size=(B, L, Cin)).astype(
            np.float32)).to(x_dtype)
        xs, dq = None, wsc
    (M, N, Kr), lout = _conv1d_dims(B, L, Cin, Cout, K, stride)
    plan = gp.gemm_plan(M, N, Kr, x_dtype, sms)
    if (Cin, sms) == (1024, 132):
        assert plan.splits > 1
    wk = wq.reshape(Kr, N) if mode == "w8a8" else wq.to(x_dtype).reshape(Kr, N)
    cols = x.reshape(-1)[torch.from_numpy(gather_offsets(
        B, 1, L, Cin, K, (1, stride), kh=1))]
    acc = split_k(cols, wk, plan)
    args = dict(x_scale=xs, mode=mode, stride=stride, activation="gelu")
    y32 = sq.conv1d_quant_plain(x, wq, wsc, b, **args)
    os = (y32.abs().max() * 0.8 / 127).reshape(()) if out == "int8" else None
    odt = BF16 if out == "bf16" else F32
    got = qconv._epilogue(acc.float() * dq, b, "gelu", os, odt).reshape(
        B, lout, N)
    want = sq.conv1d_quant_plain(x, wq, wsc, b, out_scale=os, out_dtype=odt,
                                 **args)
    assert got.dtype == want.dtype
    if mode == "w8a8":
        assert torch.equal(got, want)
    elif out == "int8":
        diff = (got.int() - want.int()).abs()
        pre = (y32 / os).reshape(-1)[diff.reshape(-1) > 0]
        assert diff.max().item() <= 1
        assert ((pre - pre.round()).abs() - 0.5).abs().max().item() < 1e-3 \
            if pre.numel() else True
    else:
        scale = max(1.0, want.float().abs().max().item())
        tol = 1e-5 if out == "f32" else 2 ** -7
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=1e-5 * scale)


# (B, L, Cin, Cout, K, stride, sms): row 10 at whisper's conv1 cut in
# length (16 tiles, 2 splits on 132 SMs), a long reduction on 2 tiles (16
# splits), phase 7's Cin 37 edge on 8 SMs, conv2 cut (192 tiles, one
# split), K = 1 with Cout 1
ROW10_SPLITS = [(2, 130, 80, 1024, 3, 1, 132),
                (4, 514, 80, 64, 3, 1, 132),
                (3, 203, 37, 70, 7, 3, 8),
                (2, 130, 1024, 1024, 3, 2, 132),
                (2, 50, 5, 1, 1, 1, 132)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,L,Cin,Cout,K,stride,sms", ROW10_SPLITS)
def test_split_order_matches_conv1d_bwd_dw_plain(B, L, Cin, Cout, K, stride,
                                                 sms, dtype):
    """Row 10: dw as the product over the B·Lout positions, A read through
    FilterRuns at kh = 1, float32 partials added in split order, and db as
    the column sums of dz in the same splits: against the plain version
    within TOL of the largest value."""
    rng = np.random.default_rng(Cin + Cout + K + 3)
    x = torch.from_numpy(rng.normal(size=(B, L, Cin)).astype(
        np.float32)).to(dtype)
    (M, N, Kr), lout = _dw1d_dims(B, L, Cin, Cout, K, stride)
    dz = torch.from_numpy(rng.normal(size=(B, lout, Cout)).astype(
        np.float32)).to(dtype)
    plan = gp.gemm_plan(M, N, Kr, dtype, sms)
    if Cout == 64:
        assert plan.splits == (16 if dtype == F32 else 8)
    a = x.reshape(-1)[torch.from_numpy(filter_run_offsets(
        B, 1, L, Cin, 1, K, (1, stride)))]
    g = dz.reshape(-1, Cout)
    dw = split_k(a, g, plan).reshape(K, Cin, Cout)
    db = split_k(torch.ones((1, Kr), dtype=dtype), g, plan)[0]
    want_dw, want_db = sb.conv1d_bwd_dw_plain(x, dz, K, stride=stride,
                                              has_bias=True)
    for got, want in ((dw, want_dw), (db, want_db)):
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale)


def test_row13_and_row10_sources_are_on_the_product_loop():
    """Rows 13 and 10 include gemm_mma.cuh and run their product through
    gm::gemm (dequant_gemm with row 14's Dequant epilogue; dw_gemm with row
    12's Store), with ConvPositions and FilterRuns at H = oh = kh = 1;
    their ctypes lists match the C signatures; the __dp4a kernel, the row
    split rule, its C export and the 1-D w8a8 pad and clone are gone;
    Dequant and FilterRuns are defined in the header alone."""
    header = (build.CSRC / "gemm_mma.cuh").read_text()
    for helper, epi in (("int dequant_gemm(", "Dequant"),
                        ("int dw_gemm(", "Store<float>")):
        body = header[header.index(helper):]
        body = body[:body.index("\n}\n")]
        assert "gemm(" in body and epi in body, helper
    entry = _c_entry("sliding_conv_quant.cu", "sliding_conv_quant")
    assert "gm::dequant_gemm(" in entry and "gm::Dequant" in entry
    assert "gm::conv_positions(1, L, Cin, K, 1, stride, 1, Lout)" in entry
    _check_argtypes(entry, sq._ARGTYPES)
    entry = _c_entry("sliding_conv_bwd.cu", "conv1d_bwd_dw")
    assert "gm::dw_gemm(" in entry
    assert "gm::filter_runs(1, L, Cin, K, 1, stride, 1, Lout)" in entry
    _check_argtypes(entry, sb._ARGTYPES)
    assert "gm::dequant_gemm(" in _c_entry("sliding_conv2d_quant.cu",
                                           "sliding_conv2d_quant")
    assert "gm::dw_gemm(" in _c_entry("sliding_conv2d_bwd.cu",
                                      "conv2d_bwd_dw")
    for name in ("sliding_conv_quant.cu", "sliding_conv_bwd.cu"):
        text = (build.CSRC / name).read_text()
        assert '#include "gemm_mma.cuh"' in text, name
        for gone in ("__dp4a", "MIN_BLOCKS", "conv1d_bwd_dw_splits",
                     "split_reduce.cuh", "227", "KT =", "CC8"):
            assert gone not in text, (name, gone)
    assert not hasattr(sb, "_SPLIT_ARGTYPES")
    wrapper = (build.CSRC.parent / "sliding_conv_quant.py").read_text()
    assert "F.pad" not in wrapper and ".clone()" not in wrapper
    for struct in ("struct Dequant", "struct FilterRuns"):
        assert header.count(struct) == 1, struct
        for path in build.CSRC.iterdir():
            if path.name != "gemm_mma.cuh":
                assert struct not in path.read_text(), (path.name, struct)
