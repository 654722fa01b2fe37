"""Launch geometry of the products on ``csrc/gemm_mma.cuh``: the tiled GEMM
(``im2col_gemm.matmul``, row 5), the fused 2-D im2col conv
(``im2col_gemm.conv2d_im2col_fused``, row 7), the 2-D weight gradient
(``sliding_conv_bwd.conv2d_bwd_dw``, row 12) and the 2-D sliding conv, fp
and int8 (``sliding_conv2d.conv2d_sliding``, row 4;
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
    holding at least one.
  * ``copy_bytes``: the widest copy (16, 8, 4 or, for bfloat16 and int8,
    2 bytes, or for int8 1) that every start address of an operand's
    vectors allows: a pointer and the strides between the vectors' starts
    must be multiples of it. ``conv2d_copy_strides`` lists those strides
    for the sliding conv's gather of x, ``im2col_copy_strides`` for row
    7's tap-by-tap gather.
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
    per = -(-chunks // splits)
    return GemmPlan(tile, -(-chunks // per), per, chunks, tiles)


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


def conv2d_copy_strides(H: int, W: int, Cin: int, kw: int,
                        stride: tuple[int, int]) -> list[int]:
    """The strides, in elements, between the starts of the sliding conv's
    copies of x (B, H, W, Cin): neighbouring output positions along a row,
    a filter row's run, an input row, neighbouring output rows, images. A
    copy of a width that divides them all starts aligned and never crosses
    from one filter row's run into the next."""
    sh, sw = stride
    return [sw * Cin, kw * Cin, W * Cin, sh * W * Cin, H * W * Cin]


def im2col_copy_strides(H: int, W: int, Cin: int,
                        stride: tuple[int, int]) -> list[int]:
    """The strides, in elements, between the starts of row 7's copies of x
    (B, H, W, Cin), which builds its column tap by tap: neighbouring output
    positions along a row, one tap's Cin channels, an input row,
    neighbouring output rows, images. A copy of a width that divides them
    all starts aligned and never crosses from one tap into the next."""
    sh, sw = stride
    return [sw * Cin, Cin, W * Cin, sh * W * Cin, H * W * Cin]
