"""Launch geometry of the products on ``csrc/gemm_mma.cuh``: the tiled GEMM
(``im2col_gemm.matmul``, row 5), the fused 1-D and 2-D im2col convs
(``im2col_gemm.conv1d_im2col_fused``, row 6; ``conv2d_im2col_fused``,
row 7), the weight gradients (``sliding_conv_bwd.conv1d_bwd_dw``, row 10;
``conv2d_bwd_dw``, row 12), the 1-D sliding conv, fp and int8
(``sliding_conv1d.conv1d_sliding``, row 1;
``sliding_conv_quant.conv1d_quant``, row 13) and the 2-D one, fp and int8
(``sliding_conv2d.conv2d_sliding``, row 4;
``sliding_conv_quant.conv2d_quant``, row 14).

The kernels take their tile, their split of the reduction and the width of
their copies from the wrapper, so the choice lives here, where the CPU
tests can hold it:

  * ``gemm_plan``: the tile (bfloat16 and int8 on their tensor-core tiles;
    float32 on the 128 x 32 one where N <= 32, else 128 x 128) and the
    split-K: one
    split where the tiles alone fill the card (``blocks_per_sm`` blocks on
    each of its SMs), else as many splits as the card holds at once
    (rounded down: a second, part-filled round of blocks would take as
    long as the first), each at least ``MIN_SPLIT_CHUNKS`` chunks of the
    reduction long, the splits covering the chunks exactly and each
    holding at least one. Where that leaves one split of more float32
    tiles than the card has SMs, some SMs hold more blocks than others
    and set the time: there the split is the one that spreads the chunks
    most evenly over the SMs (``_balanced_splits``). On the tensor-core
    tiles a chunk takes a fraction of a float32 chunk's time, and the
    pass that adds the splits' partials costs more than the chunks it
    spreads, so they keep one split there.
  * ``launch``: a wrapper's whole launch geometry, the plan and copy
    widths for its operands and the splits' workspace.
  * ``copy_bytes``: the widest copy (16, 8, 4 or, for bfloat16 and int8,
    2 bytes, or for int8 1) that every start address of an operand's
    vectors allows: a pointer and the strides between the vectors' starts
    must be multiples of it. ``conv2d_copy_strides`` lists those strides
    for the sliding convs' gather of x, ``im2col_copy_strides`` for rows 6
    and 7's tap-by-tap gather, ``dw_copy_strides`` for the weight
    gradients'; a 1-D conv over x (B, L, Cin) is the case H = 1, W = L, kw
    = K, stride (1, stride).

The depthwise convs follow the same terms on their own kernels:

  * ``depthwise_plan``: the persistent grid, the item length and the ring
    of ``csrc/depthwise_rows.cuh`` (rows 3 and 15,
    ``sliding_conv1d.conv1d_depthwise`` and
    ``sliding_conv_quant.conv1d_depthwise_quant``).
  * ``depthwise_dw_splits``: row 11's split of its row tiles
    (``sliding_conv_bwd.conv1d_depthwise_bwd_dw``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import build


@dataclass(frozen=True)
class Tile:
    """One of the header's tiles: its id in the C entries (``TileId``),
    BM x BN outputs a block, BK reduction elements a chunk, and the blocks
    of it an SM holds at once (the kernel's ``__launch_bounds__``)."""
    id: int
    bm: int
    bn: int
    bk: int
    blocks_per_sm: int


TILES = {
    "mma": Tile(0, 128, 128, 32, 2),      # bfloat16, mma.sync
    "wide": Tile(1, 128, 128, 16, 2),     # float32, N > 32
    "narrow": Tile(2, 128, 32, 16, 6),    # float32, N <= 32
    "int8": Tile(3, 128, 128, 64, 2),     # int8, mma.sync
}
# a split shorter than this many chunks moves more partial sums than it
# saves time
MIN_SPLIT_CHUNKS = 8


@dataclass(frozen=True)
class GemmPlan:
    tile: Tile
    splits: int
    per: int      # chunks of the reduction a split walks
    chunks: int   # ceil(K / tile.bk)
    tiles: int    # output tiles, blocks a split

    def split_range(self, s: int) -> tuple[int, int]:
        """Reduction elements [lo, hi) of split ``s`` for a reduction of K
        elements (the last split ends at K)."""
        return s * self.per * self.tile.bk, (s + 1) * self.per * self.tile.bk


def pick_tile(N: int, dtype: torch.dtype) -> Tile:
    if dtype == torch.bfloat16:
        return TILES["mma"]
    if dtype == torch.int8:
        return TILES["int8"]
    if dtype == torch.float32:
        return TILES["narrow"] if N <= 32 else TILES["wide"]
    raise TypeError(f"no product tile for {dtype}")


def gemm_plan(M: int, N: int, K: int, dtype: torch.dtype,
              sms: int = build.DEFAULT_SMS) -> GemmPlan:
    """The tile and the split-K of C (M, N) = A (M, K) @ B (K, N) on a card
    of ``sms`` SMs."""
    if min(M, N, K, sms) < 1:
        raise ValueError(f"empty product or card: M={M} N={N} K={K} "
                         f"sms={sms}")
    tile = pick_tile(N, dtype)
    tiles = -(-M // tile.bm) * -(-N // tile.bn)
    chunks = -(-K // tile.bk)
    fill = tile.blocks_per_sm * sms
    splits = 1
    if tiles < fill:
        splits = max(1, min(fill // tiles, chunks // MIN_SPLIT_CHUNKS))
        if splits == 1 and tiles > sms and dtype == torch.float32:
            splits = _balanced_splits(tiles, chunks, sms, fill)
    per = -(-chunks // splits)
    return GemmPlan(tile, -(-chunks // per), per, chunks, tiles)


def _balanced_splits(tiles: int, chunks: int, sms: int, fill: int) -> int:
    """The split of one round of ``tiles`` blocks, more than the card's
    ``sms`` SMs (``fill`` blocks a round), that gives the SM with the most
    work the fewest chunks to walk: s splits put ceil(s·tiles / sms)
    blocks of ceil(chunks / s) chunks on it. Unsplit, the SMs holding two
    blocks take twice as long as those holding one. The fewest splits
    among the best, each at least ``MIN_SPLIT_CHUNKS`` chunks long, in at
    most two rounds of blocks: more splits add more partials than they
    spread chunks."""
    def most(s):
        return -(-s * tiles // sms) * -(-chunks // s)

    top = max(1, min(chunks // MIN_SPLIT_CHUNKS, 2 * fill // tiles))
    return min(range(1, top + 1), key=lambda s: (most(s), s))


def copy_bytes(elem: int, ptrs, strides) -> int:
    """The widest copy, of 16, 8, 4, 2 (for elements of 2 bytes or 1) and 1
    (for 1-byte elements) bytes, that starts aligned at every vector: each
    pointer a multiple of it and each stride (in elements) between the
    starts of two vectors a multiple of its element count."""
    for v in (16, 8, 4, 2, 1):
        if v < elem:
            break
        n = v // elem
        if all(p % v == 0 for p in ptrs) and all(s % n == 0 for s in strides):
            return v
    raise ValueError(f"no copy width for {elem}-byte elements")


def launch(x: torch.Tensor, w: torch.Tensor, M: int, K: int, x_strides,
           col_sums: bool = False
           ) -> tuple[GemmPlan, int, int, torch.Tensor | None]:
    """The launch of a product whose A is gathered from contiguous x and
    whose B is the contiguous (K, N) matrix w (N its last dimension): the
    plan on x's card, the copy widths of x (``x_strides``: the strides, in
    elements, between the starts of its copies) and of w, and the splits'
    workspace (int32 partials for int8 x, float32 otherwise; None for one
    split), with room for the splits' column sums of w too where
    ``col_sums`` (the weight gradients' db)."""
    N = w.shape[-1]
    plan = gemm_plan(M, N, K, x.dtype, build.sm_count(x.device))
    va = copy_bytes(x.element_size(), [x.data_ptr()], x_strides)
    vb = copy_bytes(w.element_size(), [w.data_ptr()], [N])
    ws = None
    if plan.splits > 1:
        ws = torch.empty((plan.splits * (M * N + (N if col_sums else 0)),),
                         device=x.device,
                         dtype=torch.int32 if x.dtype == torch.int8
                         else torch.float32)
    return plan, va, vb, ws


def conv2d_copy_strides(H: int, W: int, Cin: int, kw: int,
                        stride: tuple[int, int]) -> list[int]:
    """The strides, in elements, between the starts of the sliding convs'
    copies of x (B, H, W, Cin): neighbouring output positions along a row,
    a filter row's run, an input row, neighbouring output rows, images. A
    copy of a width that divides them all starts aligned and never crosses
    from one filter row's run into the next."""
    sh, sw = stride
    return [sw * Cin, kw * Cin, W * Cin, sh * W * Cin, H * W * Cin]


def im2col_copy_strides(H: int, W: int, Cin: int,
                        stride: tuple[int, int]) -> list[int]:
    """The strides, in elements, between the starts of rows 6 and 7's
    copies of x (B, H, W, Cin), which build their column tap by tap:
    neighbouring output positions along a row, one tap's Cin channels, an
    input row, neighbouring output rows, images. A copy of a width that
    divides them all starts aligned and never crosses from one tap into
    the next."""
    sh, sw = stride
    return [sw * Cin, Cin, W * Cin, sh * W * Cin, H * W * Cin]


def dw_copy_strides(W: int, Cin: int, kw: int, sw: int) -> list[int]:
    """The strides, in elements, between the starts of the weight
    gradients' copies of x (B, H, W, Cin), which run along a filter row's
    kw·Cin values: a filter row's run, an input row, neighbouring output
    positions along a row (images and output rows are input rows apart).
    A copy of a width that divides them all starts aligned and never
    crosses from one filter row's run into the next."""
    return [kw * Cin, W * Cin, sw * Cin]


# ---------------------------------------------------------------------------
# the depthwise convs: rows 3 and 15 on csrc/depthwise_rows.cuh, row 11's
# split

DW_SLAB = 128        # channels of a work item (the kernel's DW_SLAB)
DW_WARPS = 4         # warps of a block, each a quarter of an item's rows
DW_RESIDENT = 8      # blocks an SM holds at once (the kernel's launch bounds)
DW_ROWS = (32, 16, 8, 4)  # output rows an item may cover, longest first
DW_STAGES = 2        # the ring's depth: one item in flight while one computes
SMEM_BLOCK = 232_448  # shared memory one block may take (Hopper)
SMEM_SM = 233_472     # an SM's; each resident block reserves 1 KB more


@dataclass(frozen=True)
class DepthwisePlan:
    """The launch of ``csrc/depthwise_rows.cuh``: work items of ``rows``
    output rows of one batch row over ``slab`` channels, numbered slab
    fastest, then chunk, then batch row; ``blocks`` persistent blocks,
    block j walking items j, j + blocks, ...; a ring of ``stages`` stages
    of ``stage_rows`` input rows each, ``smem`` bytes a block, ``per_sm``
    blocks resident on an SM."""
    slab: int
    rows: int
    stages: int
    blocks: int
    stage_rows: int
    slabs: int
    chunks: int
    items: int
    smem: int
    per_sm: int


def depthwise_plan(B: int, Lout: int, C: int, elem_bytes: int, K: int,
                   stride: int, sms: int = build.DEFAULT_SMS,
                   rows: int | None = None,
                   stages: int | None = None) -> DepthwisePlan:
    """The plan of a depthwise conv of (B, Lout, C) outputs over
    ``elem_bytes``-byte inputs with K taps at ``stride`` on a card of
    ``sms`` SMs: the longest chunk of rows (``DW_ROWS``) whose items still
    fill a round of resident blocks (else the shortest that fits), a ring
    of ``DW_STAGES`` stages, and as many blocks as the card holds at once,
    fewer where fewer share the items as evenly (ceil(items / rounds) for
    the rounds the items take). On the H100 at jamba's prefill shape, 32
    rows beat 16 and 64, and 2 stages beat 3 and 4 (PERF.md §6): a
    deeper ring holds more bytes per block for no more overlap, since a
    block walks only a few items. ``rows`` and ``stages`` force the choice
    (a multiple of ``DW_WARPS`` up to 64; 2 to 4). Raises where not even
    the shortest chunk's 2 stages fit."""
    if min(B, Lout, C, elem_bytes, K, stride, sms) < 1:
        raise ValueError(f"empty depthwise conv or card: B={B} Lout={Lout} "
                         f"C={C} elem={elem_bytes} K={K} stride={stride} "
                         f"sms={sms}")
    if rows is not None and (rows % DW_WARPS or not 0 < rows <= 64):
        raise ValueError(f"rows={rows}: a multiple of {DW_WARPS} up to 64")
    if stages is not None and not 2 <= stages <= 4:
        raise ValueError(f"stages={stages}: 2 to 4")
    slabs = -(-C // DW_SLAB)
    plan = None
    for R in (DW_ROWS if rows is None else (rows,)):
        stage_rows = stride * (R - 1) + K
        stage = stage_rows * DW_SLAB * elem_bytes
        depth = DW_STAGES if stages is None else stages
        if depth * stage > SMEM_BLOCK:
            continue
        per_sm = min(DW_RESIDENT, SMEM_SM // (depth * stage + 1024))
        chunks = -(-Lout // R)
        items = B * chunks * slabs
        fill = sms * per_sm
        blocks = -(-items // -(-items // fill))
        plan = DepthwisePlan(DW_SLAB, R, depth, blocks, stage_rows, slabs,
                             chunks, items, depth * stage, per_sm)
        if items >= fill:
            break
    if plan is None:
        raise ValueError(f"depthwise K={K} at stride {stride}: no ring of "
                         f"{DW_SLAB * elem_bytes}-byte rows fits a block's "
                         f"{SMEM_BLOCK} bytes of shared memory")
    return plan


# row 11 (csrc/conv1d_depthwise_bwd.cu): 128-thread blocks of 16 bytes of
# channels a thread, tiles of 32 dz rows, groups of 4 taps past K = 4
DW_BWD_THREADS = 128
DW_BWD_TILE = 32
DW_BWD_TAPS = 4


def depthwise_dw_splits(B: int, C: int, K: int, Lout: int,
                        dtype: torch.dtype,
                        sms: int = build.DEFAULT_SMS) -> int:
    """Row 11's split of its B·ceil(Lout / 32) row tiles: 1 where its
    channel blocks (times its tap groups) fill the card's ``sms`` SMs, else
    enough splits for two blocks an SM, at most one a tile. The caller
    gives the kernel a workspace of S·(K·C + C) floats when S > 1."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"row 11 takes float32 or bfloat16, not {dtype}")
    vecs = -(-C // (8 if dtype == torch.bfloat16 else 4))  # 16 bytes each
    groups = 1 if K <= DW_BWD_TAPS else -(-K // DW_BWD_TAPS)
    blocks = -(-vecs // DW_BWD_THREADS) * groups
    tiles = B * -(-Lout // DW_BWD_TILE)
    if blocks >= sms:
        return 1
    return min(-(-2 * sms // blocks), tiles)
