"""The launch geometry of the depthwise convs, on the CPU, where no kernel
runs: ``gemm_plan.depthwise_plan`` (rows 3 and 15 on
``csrc/depthwise_rows.cuh``: work items, the ring, the persistent grid)
and ``gemm_plan.depthwise_dw_splits`` (row 11's split of its row tiles),
the wrappers' copy widths, and the C entries against their ctypes lists.
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, gemm_plan as gp  # noqa: E402
from repro_torch.kernels import sliding_conv1d as s1  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as sb  # noqa: E402
from repro_torch.kernels import sliding_conv_quant as sq  # noqa: E402

SMS = (build.DEFAULT_SMS, 114, 78, 1)
# (what, B, Lout, C, elem bytes, K, stride): jamba's prefill and training
# convs (bf16; int8 codes; f32), then the card tests' edges
SHAPES = [
    ("prefill bf16", 4, 256, 16384, 2, 4, 1),
    ("train bf16", 2, 512, 16384, 2, 4, 1),
    ("prefill int8", 4, 256, 16384, 1, 4, 1),
    ("prefill f32", 4, 256, 16384, 4, 4, 1),
    ("edge C 37", 3, 200, 37, 4, 4, 1),
    ("edge Lout 3", 3, 3, 600, 2, 5, 2),
    ("edge C 1032", 3, 30, 1032, 1, 5, 2),
    ("edge K 2", 3, 202, 37, 2, 2, 1),
    ("every activation", 2, 149, 1032, 4, 4, 2),
]


def test_lanes_cover_the_slab():
    """A warp's 32 lanes, 4 neighbouring channels each (the kernel's
    DW_LANE), own each of the slab's channels once."""
    owned = sorted(lane * 4 + j for lane in range(32) for j in range(4))
    assert owned == list(range(gp.DW_SLAB))
    header = (build.CSRC / "depthwise_rows.cuh").read_text()
    assert "constexpr int DW_LANE = 4;" in header
    for name in ("DW_WARPS", "DW_RESIDENT"):
        m = re.search(rf"constexpr int {name} = ([^;]+);", header)
        assert m and eval(m.group(1), {"DW_THREADS": 128}) == getattr(gp, name)


def _item(p, i, Lout, C):
    """Item ``i``'s batch row, output rows [r0, r1) and channels [c0, c1),
    as the kernel decodes it: slab fastest, then chunk, then batch row."""
    slab, rest = i % p.slabs, i // p.slabs
    chunk, b = rest % p.chunks, rest // p.chunks
    r0, c0 = chunk * p.rows, slab * p.slab
    return b, r0, min(r0 + p.rows, Lout), c0, min(c0 + p.slab, C)


def _items_of(p, block):
    """The items block ``block`` walks, in order (j, j + grid, ...)."""
    return range(block, p.items, p.blocks)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("what,B,Lout,C,elem,K,stride", SHAPES)
def test_plan_covers_every_output_once(what, B, Lout, C, elem, K, stride,
                                       sms):
    """The blocks' items, each split over the warps' row ranges, cover
    every (batch row, output row, channel) exactly once."""
    p = gp.depthwise_plan(B, Lout, C, elem, K, stride, sms)
    count = np.zeros((B, Lout, C), dtype=np.uint8)
    rw = p.rows // gp.DW_WARPS
    for block in range(p.blocks):
        for i in _items_of(p, block):
            b, r0, r1, c0, c1 = _item(p, i, Lout, C)
            assert c1 - c0 <= p.slab and r1 - r0 <= p.rows
            for warp in range(gp.DW_WARPS):
                o0 = r0 + warp * rw
                count[b, o0:min(o0 + rw, r1), c0:c1] += 1
    assert (count == 1).all(), what


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("what,B,Lout,C,elem,K,stride", SHAPES)
def test_ring_fits_and_blocks_bounded(what, B, Lout, C, elem, K, stride,
                                      sms):
    """The ring fits a block's 227 KB of shared memory and ``per_sm``
    rings an SM's; no more blocks than the card holds at once, no more
    than the items, each block within one item of the others."""
    p = gp.depthwise_plan(B, Lout, C, elem, K, stride, sms)
    assert p.stage_rows == stride * (p.rows - 1) + K
    assert p.smem == p.stages * p.stage_rows * gp.DW_SLAB * elem
    assert p.smem <= 232_448 and 2 <= p.stages <= 4
    assert 1 <= p.per_sm <= gp.DW_RESIDENT
    assert p.per_sm * (p.smem + 1024) <= 233_472
    assert p.blocks <= min(p.items, sms * p.per_sm)
    assert p.items == B * math.ceil(Lout / p.rows) * math.ceil(C / p.slab)
    walks = {len(_items_of(p, j)) for j in range(p.blocks)}
    assert min(walks) >= 1 and max(walks) - min(walks) <= 1


def test_plan_at_the_h100():
    """Jamba's convs on 132 SMs: items of 32 rows through a 2-stage ring,
    as many blocks as hold the 4,096 items in even rounds (bf16 and int8:
    1,024 blocks, a multiple of the 128 slabs, so that each block keeps
    one slab's weights)."""
    for elem, blocks, per_sm in ((2, 1024, 8), (1, 1024, 8), (4, 683, 6)):
        for B, Lout in ((4, 256), (2, 512)):
            p = gp.depthwise_plan(B, Lout, 16384, elem, 4, 1)
            assert (p.rows, p.stages, p.items) == (32, 2, 4096)
            assert (p.blocks, p.per_sm) == (blocks, per_sm)
    # in flight per SM: the stages ahead of the one computing, >= 32 KB
    p = gp.depthwise_plan(4, 256, 16384, 1, 4, 1)
    assert (p.stages - 1) * p.smem // p.stages * p.per_sm >= 32 * 1024


def test_plan_follows_the_sm_count():
    """Fewer SMs: fewer blocks, each walking more items; items too few to
    fill the card take a shorter chunk."""
    blocks = [gp.depthwise_plan(4, 256, 16384, 2, 4, 1, s).blocks
              for s in (132, 78, 2)]
    assert blocks == sorted(blocks, reverse=True) and blocks[-1] == 16
    assert gp.depthwise_plan(4, 256, 16384, 2, 4, 1) == gp.depthwise_plan(
        4, 256, 16384, 2, 4, 1, build.DEFAULT_SMS)
    assert gp.depthwise_plan(1, 200, 37, 2, 4, 1).rows == 4
    assert gp.depthwise_plan(1, 200, 37, 2, 4, 1, 1).rows == 16


@pytest.mark.parametrize("rows", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("stages", [2, 3, 4])
def test_forced_plans(rows, stages):
    """``rows`` and ``stages`` force the choice (bf16 at stride 1 and int8
    codes at stride 2, the card tests' forced shapes, fit every pair) and
    the forced items still cover every output once."""
    real = gp.depthwise_plan
    for elem, stride in ((2, 1), (1, 2)):
        p = real(2, 297, 600, elem, 4, stride, rows=rows, stages=stages)
        assert (p.rows, p.stages) == (rows, stages)
        gp.depthwise_plan = lambda *a: real(*a, rows=rows, stages=stages)
        try:
            test_plan_covers_every_output_once("forced", 2, 297, 600, elem,
                                               4, stride, 132)
        finally:
            gp.depthwise_plan = real


def test_plans_refused():
    """A chunk the kernel does not take, a ring depth out of range, an
    empty shape, or a filter whose 2 stages fit no block raise."""
    for kw in (dict(rows=6), dict(rows=128), dict(rows=0), dict(stages=1),
               dict(stages=5)):
        with pytest.raises(ValueError):
            gp.depthwise_plan(2, 100, 64, 2, 4, 1, **kw)
    with pytest.raises(ValueError):
        gp.depthwise_plan(0, 100, 64, 2, 4, 1)
    with pytest.raises(ValueError):
        gp.depthwise_plan(1, 300, 64, 4, 250, 1)  # 2 x 253 rows of 512 B
    assert gp.depthwise_plan(1, 500, 64, 2, 400, 1).rows == 4


def _old_dw_splits(B, C, K, Lout, is_bf16):
    """The split rule the row-11 source held before it took its split from
    the wrapper (conv1d_depthwise_bwd_dw_splits, MIN_BLOCKS = 2 * 132),
    transcribed."""
    vec = 8 if is_bf16 else 4
    vecs = (C + vec - 1) // vec
    groups = 1 if K <= 4 else (K + 3) // 4
    blocks = ((vecs + 127) // 128) * groups
    n_tiles = B * ((Lout + 31) // 32)
    if blocks >= 264 // 2:
        return 1
    want = (264 + blocks - 1) // blocks
    return want if want < n_tiles else n_tiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 2, 4, 5, 9, 20])
def test_dw_splits_match_the_old_rule(K, dtype):
    """At 132 SMs the rule returns what the C rule returned, so row 11's
    sums keep their order: over batch rows, channels and lengths."""
    for B, C, Lout in ((1, 37, 1), (2, 16384, 512), (3, 600, 45),
                       (2, 16384, 45), (8, 65536, 300), (1, 135168, 64),
                       (4, 4096, 2000), (1, 1, 10_000)):
        assert gp.depthwise_dw_splits(B, C, K, Lout, dtype) == \
            _old_dw_splits(B, C, K, Lout, dtype == torch.bfloat16)


def test_dw_splits_at_the_training_shape():
    """Jamba's training shape (B 2, C 16384, K 4, Lout 512): 17 splits in
    bf16 (16 used: 32 tiles of 2), 9 in f32 (8 used: 32 tiles of 4)."""
    assert gp.depthwise_dw_splits(2, 16384, 4, 512, torch.bfloat16) == 17
    assert gp.depthwise_dw_splits(2, 16384, 4, 512, torch.float32) == 9
    for S, used in ((17, 16), (9, 8)):
        per = math.ceil(32 / S)
        assert math.ceil(32 / per) == used


def test_dw_splits_follow_the_sm_count():
    """Fewer SMs, fewer splits; channel blocks that fill the card, one."""
    splits = [gp.depthwise_dw_splits(2, 16384, 4, 512, torch.bfloat16, s)
              for s in (132, 66, 32, 16)]
    assert splits == [17, 9, 4, 1]  # 16 channel blocks
    with pytest.raises(TypeError):
        gp.depthwise_dw_splits(2, 64, 4, 32, torch.float16)


@pytest.mark.parametrize("dtype,C,offset,want", [
    (torch.bfloat16, 16384, 0, 16), (torch.bfloat16, 16384, 1, 2),
    (torch.float32, 37, 0, 4), (torch.float32, 600, 2, 8),
    (torch.int8, 16384, 0, 16), (torch.int8, 37, 0, 1),
    (torch.int8, 600, 4, 4)])
def test_wrappers_copy_width(dtype, C, offset, want):
    """The staged pieces are as wide as x's base and its row length allow
    (its rows start C elements apart); the plan is the one on the card's
    SM count (the default for a CPU tensor)."""
    buf = torch.zeros(2 * 40 * C + offset, dtype=dtype)
    x = buf[offset:].view(2, 40, C)
    plan, cb = s1.depthwise_launch(x, 4, 1, 37)
    assert cb == want
    assert plan == gp.depthwise_plan(2, 37, C, x.element_size(), 4, 1)


def _c_entry(source, name):
    text = (build.CSRC / source).read_text()
    entry = text[text.index(f'extern "C" int {name}('):]
    return entry[:entry.index('extern "C"', 10)]


def _check_argtypes(entry, argtypes):
    """A C entry's parameters against its wrapper's ctypes list: as many,
    and a pointer (``c_void_p``) exactly where the C parameter is one."""
    params = entry[entry.index("(") + 1 : entry.index(")")].split(",")
    assert len(params) == len(argtypes)
    for prm, t in zip(params, argtypes):
        assert ("*" in prm) == (t is s1.ctypes.c_void_p), prm


def test_sources_are_on_the_staged_body():
    """Rows 3 and 15 launch depthwise_rows.cuh's body through
    launch_depthwise_k, with their ctypes lists matching the C signatures;
    the per-thread row walks, row 15's own loads and row 11's split rule
    and SM count are gone."""
    header = (build.CSRC / "depthwise_rows.cuh").read_text()
    assert '#include "cp_async.cuh"' in header
    assert "depthwise_rows(" in header and "cp_wait_pending(" in header
    for src, name, argtypes in (
            ("conv1d_depthwise.cu", "conv1d_depthwise", s1._DW_ARGTYPES),
            ("conv1d_depthwise_quant.cu", "conv1d_depthwise_quant",
             sq._DW_ARGTYPES),
            ("conv1d_depthwise_bwd.cu", "conv1d_depthwise_bwd_dw",
             sb._DW_ARGTYPES)):
        entry = _c_entry(src, name)
        _check_argtypes(entry, argtypes)
        text = (build.CSRC / src).read_text()
        assert '#include "depthwise_rows.cuh"' in text
        for gone in ("MIN_BLOCKS", "conv1d_depthwise_bwd_dw_splits",
                     "constexpr int TL = 16", "load_vals", "struct Lanes",
                     "struct Raw", "store_out(", "store_vals"):
            assert gone not in text, (src, gone)
        assert not re.search(r"\b132\b", text), src
        if src != "conv1d_depthwise_bwd.cu":
            assert "launch_depthwise_k<" in text, src
    assert not re.search(r"\b132\b", header)
    assert "store_vals" not in header
    assert not hasattr(sb, "_DW_SPLIT_ARGTYPES")
    gemm = (build.CSRC / "gemm_mma.cuh").read_text()
    assert '#include "cp_async.cuh"' in gemm
    assert "void copy_in(" not in gemm and "void cp_wait(" not in gemm
