"""The launch geometry of the products on ``csrc/gemm_mma.cuh`` (the tiled
GEMM, row 5, the 2-D weight gradient, row 12, and the 2-D sliding conv,
fp and int8, rows 4 and 14), on the CPU, where no kernel runs:
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
                 build.CSRC / "im2col_gemm.cu",
                 build.CSRC / "sliding_conv2d.cu",
                 build.CSRC / "sliding_conv2d_quant.cu"):
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


def gather_offsets(B, H, W, Cin, k, stride):
    """ConvPositions transcribed: x's flat offset of A[p, k], at(row(p)) +
    col(k), every divide a FastDiv."""
    (M, _, K), (oh, ow) = _conv_dims(B, H, W, Cin, 1, k, stride)
    sh, sw = stride
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


def test_row7_source_is_on_the_product_loop():
    """Row 7 calls gm::gemm with its tap gather; Cols2d and row 7's
    gemm_tile.cuh path are gone; gemm_tile.cuh serves row 6 alone."""
    text = (build.CSRC / "im2col_gemm.cu").read_text()
    entry = text[text.index('extern "C" int im2col_conv2d'):]
    entry = entry[:entry.index('extern "C"', 10)]
    assert "gm::gemm" in entry and "TapColumns" in entry
    assert "Cols2d" not in text and "launch(" not in entry
    assert "Cols1d" in text
    assert "row 6" in (build.CSRC / "gemm_tile.cuh").read_text()
    params = entry[entry.index("(") + 1 : entry.index(")")].split(",")
    assert len(params) == len(ig._2D_ARGTYPES)
    for prm, t in zip(params, ig._2D_ARGTYPES):
        assert ("*" in prm) == (t is ig.ctypes.c_void_p), prm
