"""CUDA launch contracts of the port's kernels, proved over the tuning space.

Every kernel of the port takes its launch from Python: the grid, the
threads of a block, the dynamic shared memory the launcher hands
``cudaFuncSetAttribute``, the tile and split of the reduction, the width of
the ``cp.async`` copies. The plan functions (``kernels/gemm_plan.py``,
``attention_decode.decode_splits``, ``sliding_pool.pool_layout``) choose
them, the C launchers check some of them again, and nothing else states
the card's limits in one place. This module does: each launcher has a
builder (``FAMILIES``) that reconstructs one launch at one shape and plan
as a :class:`KernelInstance`, from the port's own plan functions, and
:func:`check_instance` holds it to the H100's limits:

  * **smem_budget**: a block's shared memory fits the budget
    (``gemm_plan.SMEM_BLOCK``, the 232,448 bytes a Hopper block may opt
    in to; the CLI's ``--smem-budget`` sets another).
  * **occupancy**: the blocks the plan counts on an SM (the
    ``__launch_bounds__`` minimum, ``Tile.blocks_per_sm`` or
    ``DW_RESIDENT``) fit the SM's ``gemm_plan.SMEM_SM`` bytes, each block
    reserving 1 KB more; ``gemm_plan``'s ``fill = blocks_per_sm × sms``
    rests on this.
  * **grid_limit**: x ≤ 2³¹−1, y and z ≤ 65,535, threads ≤ 1,024.

The reference also checks halo bounds, accumulator widening and revisit
races. The port's builders take those facts (the copies' widths and ends,
the accumulator's type, a split's workspace) from the plan functions
that impose them, so a check of them could fire only on an instance made
by hand; the wrappers' own plans, widths and workspaces are held to the
builders' by the CPU tests instead.

A builder declares a plan's shared memory before it asks the plan
function, so a forced plan that its plan function refuses for its bytes
is flagged ``smem_budget`` rather than dropped. On the card, each
instance's ``query`` names the launcher's query entry, which returns the
bytes and threads the launcher itself would use: ``chip_smoke.py`` holds
every instance of the key space to it.

The checks are integer arithmetic, so the whole key space (the
reference's shapes and the port's full-width model shapes × the tuning
candidates) is checked in seconds, on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator

import torch

from repro_torch.kernels import attention_decode as attn_dec
from repro_torch.kernels import build, gemm_plan
from repro_torch.kernels import sliding_pool as spool

DTYPE_BYTES = {"int8": 1, "bfloat16": 2, "float32": 4, "int32": 4}
TORCH_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16,
                "float32": torch.float32}
# the C entries' codes of an operand type (x_kind, kv_kind)
KIND = {"float32": 0, "bfloat16": 1, "int8": 2}

GRID_X_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65_535
THREADS_MAX = 1_024
# shared memory an SM keeps for each resident block beyond its own
BLOCK_RESERVE = 1_024


def smem_budget() -> int:
    """Shared memory a block may take, in bytes: the H100's opt-in limit
    ``gemm_plan.SMEM_BLOCK``."""
    return gemm_plan.SMEM_BLOCK


def device_smem_budget(device: torch.device | int | None = None) -> int:
    """The opt-in shared memory a block may take on a card, read from the
    device (``shared_memory_per_block_optin``)."""
    index = torch.cuda.current_device() if device is None else (
        device if isinstance(device, int) else device.index or 0)
    return torch.cuda.get_device_properties(
        index).shared_memory_per_block_optin


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Violation:
    """One typed violation. ``kind``: smem_budget | occupancy | grid_limit
    | bloat | chain_dequant | cost_model | cost_rank | acc_overflow |
    requant_clip | scale_fold | lint_*."""

    kind: str
    family: str
    key: str
    detail: str

    def line(self) -> str:
        return f"[{self.kind}] {self.family} {self.key}: {self.detail}"


@dataclasses.dataclass(frozen=True)
class Copy:
    """One operand's copies into shared memory (or its loads): the bytes a
    copy moves, and the bytes one block reads of the operand (the cost
    model's traffic; halo and weight re-reads included)."""

    name: str
    width: int
    block_bytes: int


@dataclasses.dataclass
class KernelInstance:
    """One launch of one kernel at one shape and plan.

    ``per_sm`` is the blocks the plan counts on an SM at once. A
    reduction split over ``splits`` blocks writes ``partial`` four-byte
    elements a split (int32 or float32) into a workspace of ``workspace``
    elements, added by a fixed second pass (over ``second_pass_blocks``
    blocks; 0: spread over the card). ``block_ops`` (in ``ops_dtype``) and
    ``smem_traffic`` are the busiest block's, as launched, padding
    included; ``out_bytes`` is written once. ``inflight_bytes`` is what a
    block keeps in flight from device memory (its ring's stages ahead of
    the one it computes on), ``serial_steps`` the busiest block's round
    trips to device memory that its ring does not hide. ``query`` is the
    launcher's query entry: (library, symbol, integer arguments)."""

    family: str
    key: str
    grid: tuple[int, int, int]
    threads: int
    smem: int
    per_sm: int
    copies: list[Copy]
    out_bytes: int
    block_ops: float
    ops_dtype: str
    smem_traffic: int
    inflight_bytes: int = 0
    serial_steps: int = 1
    splits: int = 1
    partial: int = 0
    workspace: int = 0
    second_pass_blocks: int = 0
    query: tuple | None = None

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)


# ---------------------------------------------------------------------------
# checker
# ---------------------------------------------------------------------------

def check_instance(inst: KernelInstance, *,
                   budget: int | None = None) -> list[Violation]:
    """Every contract violation of one launch."""
    budget = smem_budget() if budget is None else budget
    vio: list[Violation] = []

    def flag(kind, detail):
        vio.append(Violation(kind, inst.family, inst.key, detail))

    if inst.smem > budget:
        flag("smem_budget", f"{inst.smem} B of shared memory a block > "
                            f"budget {budget} B")
    want = inst.per_sm * (inst.smem + BLOCK_RESERVE)
    if want > gemm_plan.SMEM_SM:
        flag("occupancy", f"{inst.per_sm} blocks an SM of {inst.smem} B "
                          f"(+{BLOCK_RESERVE} B each) take {want} B > an "
                          f"SM's {gemm_plan.SMEM_SM} B")
    gx, gy, gz = inst.grid
    if not (1 <= gx <= GRID_X_MAX and 1 <= gy <= GRID_YZ_MAX
            and 1 <= gz <= GRID_YZ_MAX) or not 1 <= inst.threads <= THREADS_MAX:
        flag("grid_limit", f"grid {inst.grid}, {inst.threads} threads: x "
                           f"<= {GRID_X_MAX}, y and z <= {GRID_YZ_MAX}, "
                           f"threads <= {THREADS_MAX}")
    return vio


# ---------------------------------------------------------------------------
# the products on csrc/gemm_mma.cuh: rows 1, 4, 5, 6, 7, 10, 12, 13, 14
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TileSmem:
    """What ``smem_bytes<Tile, T, Gather>`` reads of a tile: its ring's
    stages, the pads of A's and B's staged rows (elements), whether B is
    staged [n][k] (``kBnk``), the threads of a block and the times a
    block's warps re-read an element of its A and B stages."""

    stages: int
    pad_a: int
    pad_b: int
    bnk: bool
    threads: int
    reads_a: int
    reads_b: int


# gemm_mma.cuh: MmaTile = Mma<128, 128, 32, 2, 4, 4, 2>, Wide = Simt<128,
# 128, 2>, Narrow = Simt<128, 32, 6>, Int8Tile = MmaS8<128, 128, 64, 2, 4,
# 4, 2>; Simt stages 3 with pads of 4 floats and 8 x 8 thread tiles
TILE_SMEM = {
    "mma": TileSmem(4, 8, 8, False, 256, 4, 2),
    "wide": TileSmem(3, 4, 4, False, 256, 16, 16),
    "narrow": TileSmem(3, 4, 4, False, 64, 4, 16),
    "int8": TileSmem(4, 16, 16, True, 256, 4, 2),
}


def product_smem(tile: str, elem: int, k_major: bool) -> int:
    """``smem_bytes<Tile, T, Gather>()`` of ``csrc/gemm_mma.cuh``: the
    ring of A and B stages in A's type (``elem`` bytes), A staged [m][k]
    where the gather runs along k (``Gather::kMajor``), else [k][m]."""
    t, s = gemm_plan.TILES[tile], TILE_SMEM[tile]
    lda = t.bk + s.pad_a if k_major else t.bm + s.pad_a
    ldb = t.bk + s.pad_b if s.bnk else t.bn + s.pad_b
    a = t.bm * lda if k_major else t.bk * lda
    b = t.bn * ldb if s.bnk else t.bk * ldb
    return s.stages * (a + b) * elem


def _product(*, family, key, M, N, K, adt, bdt, odt, a_strides, query,
             k_major=True, out_elems=None,
             col_sums=False, tile=None, splits=None,
             sms=build.DEFAULT_SMS) -> KernelInstance:
    """A product C (M, N) = A (M, K) @ B (K, N) planned by
    ``gemm_plan.gemm_plan`` with copy widths from ``gemm_plan.copy_bytes``
    (storage 256-byte aligned, as PyTorch allocates it)."""
    plan = gemm_plan.gemm_plan(M, N, K, TORCH_DTYPES[adt], sms, tile=tile,
                               splits=splits)
    t, ts = plan.tile, TILE_SMEM[plan.tile.name]
    ea, eb = DTYPE_BYTES[adt], DTYPE_BYTES[bdt]
    kb = min(plan.per * t.bk, K)  # reduction elements a block walks
    a_blk, b_blk = min(t.bm, M) * kb * ea, kb * min(t.bn, N) * eb
    staged = t.bm * t.bk * ea + t.bk * t.bn * ea  # a chunk's stages
    return KernelInstance(
        family=family, key=key,
        grid=(_cdiv(M, t.bm), _cdiv(N, t.bn), plan.splits),
        threads=ts.threads, smem=product_smem(t.name, ea, k_major),
        per_sm=t.blocks_per_sm,
        copies=[Copy("a", gemm_plan.copy_bytes(ea, [0], a_strides), a_blk),
                Copy("b", gemm_plan.copy_bytes(eb, [0], [N]), b_blk)],
        out_bytes=(M * N if out_elems is None else out_elems)
        * DTYPE_BYTES[odt],
        block_ops=2.0 * t.bm * t.bn * plan.per * t.bk, ops_dtype=adt,
        smem_traffic=plan.per * (staged + t.bm * t.bk * ea * ts.reads_a
                                 + t.bk * t.bn * ea * ts.reads_b),
        inflight_bytes=(ts.stages - 1) * staged,
        serial_steps=_cdiv(plan.per, ts.stages - 1) + 1,
        splits=plan.splits, partial=M * N + (N if col_sums else 0),
        workspace=(plan.splits * (M * N + (N if col_sums else 0))
                   if plan.splits > 1 else 0),
        query=(*query, plan.tile.id),
    )


def _precision_types(precision: str, dtype: str) -> tuple[str, str]:
    """(A's type, B's type) of a conv's product: fp on ``dtype``, w8a8 on
    int8 codes, w8a16 on ``dtype`` against int8 codes."""
    if precision == "fp":
        return dtype, dtype
    if precision == "w8a8":
        return "int8", "int8"
    if precision == "w8a16":
        return dtype, "int8"
    raise ValueError(f"unknown precision {precision!r}")


def build_conv1d(*, B, L, Cin, Cout, K, stride=1, precision="fp",
                 dtype="float32", sms=build.DEFAULT_SMS, tile=None,
                 splits=None) -> KernelInstance:
    """Rows 1 (``sliding_conv1d``) and 13 (``sliding_conv_quant``): a
    VALID conv1d as one product over the B·Lout positions, A gathered
    from x (B, L, Cin) along each position's K·Cin run."""
    lout = (L - K) // stride + 1
    if lout < 1:
        raise ValueError(f"K={K} stride={stride} exceeds L={L}")
    adt, bdt = _precision_types(precision, dtype)
    lib = "sliding_conv1d" if precision == "fp" else "sliding_conv_quant"
    return _product(
        family=f"conv1d.{precision}",
        key=f"conv1d|B{B}|L{L}|Cin{Cin}|Cout{Cout}|K{K}|s{stride}|"
            f"{precision if precision != 'fp' else dtype}",
        M=B * lout, N=Cout, K=K * Cin, adt=adt, bdt=bdt, odt=dtype,
        a_strides=gemm_plan.conv2d_copy_strides(1, L, Cin, K, (1, stride)),
        query=(lib, f"{lib}_query", KIND[adt]),
        tile=tile, splits=splits, sms=sms)


def build_conv2d(*, B, H, W, Cin, Cout, kh, kw, stride=(1, 1),
                 precision="fp", dtype="float32", sms=build.DEFAULT_SMS,
                 tile=None, splits=None) -> KernelInstance:
    """Rows 4 (``sliding_conv2d``) and 14 (``sliding_conv2d_quant``): a
    VALID conv2d as one product over the B·oh·ow positions, A gathered
    from x (B, H, W, Cin) along each filter row's kw·Cin run."""
    sh, sw = stride
    oh, ow = (H - kh) // sh + 1, (W - kw) // sw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"filter ({kh}, {kw}) exceeds input ({H}, {W})")
    adt, bdt = _precision_types(precision, dtype)
    lib = "sliding_conv2d" if precision == "fp" else "sliding_conv2d_quant"
    return _product(
        family=f"conv2d.{precision}",
        key=f"conv2d|B{B}|H{H}|W{W}|Cin{Cin}|Cout{Cout}|K{kh}x{kw}|"
            f"s{sh}x{sw}|{precision if precision != 'fp' else dtype}",
        M=B * oh * ow, N=Cout, K=kh * kw * Cin, adt=adt, bdt=bdt,
        odt=dtype,
        a_strides=gemm_plan.conv2d_copy_strides(H, W, Cin, kw, (sh, sw)),
        query=(lib, f"{lib}_query", KIND[adt]), tile=tile, splits=splits,
        sms=sms)


def build_conv1d_bwd_dw(*, B, L, Cin, Cout, K, stride=1, dtype="float32",
                        has_bias=True, sms=build.DEFAULT_SMS, tile=None,
                        splits=None) -> KernelInstance:
    """Row 10 (``sliding_conv_bwd.conv1d_bwd_dw``): dw (K·Cin, Cout) = the
    product over the B·Lout positions of dz, A gathered [k][m] from x
    along each filter row's run (``FilterRuns``), db the column sums."""
    lout = (L - K) // stride + 1
    if lout < 1:
        raise ValueError(f"K={K} stride={stride} exceeds L={L}")
    return _product(
        family="conv1d_bwd_dw",
        key=f"conv1d|B{B}|L{L}|Cin{Cin}|Cout{Cout}|K{K}|s{stride}|{dtype}"
            f"|grad",
        M=K * Cin, N=Cout, K=B * lout, adt=dtype, bdt=dtype, odt="float32",
        a_strides=gemm_plan.dw_copy_strides(L, Cin, K, stride),
        k_major=False, col_sums=has_bias,
        query=("sliding_conv_bwd", "conv1d_bwd_dw_query", KIND[dtype]),
        tile=tile, splits=splits, sms=sms)


def build_conv2d_bwd_dw(*, B, H, W, Cin, Cout, kh, kw, stride=(1, 1),
                        dtype="float32", has_bias=True,
                        sms=build.DEFAULT_SMS, tile=None,
                        splits=None) -> KernelInstance:
    """Row 12 (``sliding_conv2d_bwd.conv2d_bwd_dw``): dw (kh·kw·Cin, Cout)
    over the B·oh·ow positions, as row 10."""
    sh, sw = stride
    oh, ow = (H - kh) // sh + 1, (W - kw) // sw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"filter ({kh}, {kw}) exceeds input ({H}, {W})")
    return _product(
        family="conv2d_bwd_dw",
        key=f"conv2d|B{B}|H{H}|W{W}|Cin{Cin}|Cout{Cout}|K{kh}x{kw}|"
            f"s{sh}x{sw}|{dtype}|grad",
        M=kh * kw * Cin, N=Cout, K=B * oh * ow, adt=dtype, bdt=dtype,
        odt="float32", a_strides=gemm_plan.dw_copy_strides(W, Cin, kw, sw),
        k_major=False, col_sums=has_bias,
        query=("sliding_conv2d_bwd", "conv2d_bwd_dw_query", KIND[dtype]),
        tile=tile, splits=splits, sms=sms)


def build_matmul(*, M, N, K, dtype="float32", sms=build.DEFAULT_SMS,
                 tile=None, splits=None) -> KernelInstance:
    """Row 5 (``im2col_gemm.matmul``): A (M, K) @ B (K, N), A's rows K
    elements apart (``MatrixRows``)."""
    return _product(
        family="matmul", key=f"matmul|M{M}|N{N}|K{K}|{dtype}",
        M=M, N=N, K=K, adt=dtype, bdt=dtype, odt=dtype, a_strides=[K],
        query=("im2col_gemm", "im2col_matmul_query", KIND[dtype]),
        tile=tile, splits=splits, sms=sms)


def build_conv1d_im2col(*, B, L, Cin, Cout, K, stride=1, dtype="float32",
                        sms=build.DEFAULT_SMS, tile=None,
                        splits=None) -> KernelInstance:
    """Row 6 (``im2col_gemm.conv1d_im2col_fused``): the column built tap by
    tap in shared memory (``TapColumns``)."""
    lout = (L - K) // stride + 1
    if lout < 1:
        raise ValueError(f"K={K} stride={stride} exceeds L={L}")
    return _product(
        family="conv1d_im2col",
        key=f"conv1d|B{B}|L{L}|Cin{Cin}|Cout{Cout}|K{K}|s{stride}|{dtype}"
            f"|im2col",
        M=B * lout, N=Cout, K=K * Cin, adt=dtype, bdt=dtype, odt=dtype,
        a_strides=gemm_plan.im2col_copy_strides(1, L, Cin, (1, stride)),
        query=("im2col_gemm", "im2col_conv1d_query", KIND[dtype]),
        tile=tile, splits=splits, sms=sms)


def build_conv2d_im2col(*, B, H, W, Cin, Cout, kh, kw, stride=(1, 1),
                        dtype="float32", sms=build.DEFAULT_SMS, tile=None,
                        splits=None) -> KernelInstance:
    """Row 7 (``im2col_gemm.conv2d_im2col_fused``)."""
    sh, sw = stride
    oh, ow = (H - kh) // sh + 1, (W - kw) // sw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"filter ({kh}, {kw}) exceeds input ({H}, {W})")
    return _product(
        family="conv2d_im2col",
        key=f"conv2d|B{B}|H{H}|W{W}|Cin{Cin}|Cout{Cout}|K{kh}x{kw}|"
            f"s{sh}x{sw}|{dtype}|im2col",
        M=B * oh * ow, N=Cout, K=kh * kw * Cin, adt=dtype, bdt=dtype,
        odt=dtype, a_strides=gemm_plan.im2col_copy_strides(H, W, Cin,
                                                           (sh, sw)),
        query=("im2col_gemm", "im2col_conv2d_query", KIND[dtype]),
        tile=tile, splits=splits, sms=sms)


# ---------------------------------------------------------------------------
# the depthwise convs on csrc/depthwise_rows.cuh: rows 3, 15 and 11
# ---------------------------------------------------------------------------

def _depthwise_x(C, elem, block_rows, extra=()):
    """The copies of x (and ``extra`` operands, each (name, rows a block))
    of a depthwise kernel: pieces as wide as a row's C elements allow."""
    width = gemm_plan.copy_bytes(elem, [0], [C])
    return [Copy(name, width, rows * gemm_plan.DW_SLAB * elem)
            for name, rows in (("x", block_rows), *extra)]


def build_conv1d_depthwise(*, B, L, C, K, stride=1, precision="fp",
                           dtype="float32", sms=build.DEFAULT_SMS, rows=None,
                           stages=None) -> KernelInstance:
    """Rows 3 (``conv1d_depthwise``) and 15 (``conv1d_depthwise_quant``): a
    persistent grid walking items of R output rows over 128 channels
    through a ring of stages (``gemm_plan.depthwise_plan``)."""
    lout = (L - K) // stride + 1
    if lout < 1:
        raise ValueError(f"K={K} stride={stride} exceeds L={L}")
    xdt = "int8" if precision == "w8a8" else dtype
    el = DTYPE_BYTES[xdt]
    key = (f"conv1ddw|B{B}|L{L}|C{C}|K{K}|s{stride}|"
           f"{precision if precision != 'fp' else dtype}")
    fam = f"conv1d_depthwise.{precision}"
    try:
        plan = gemm_plan.depthwise_plan(B, lout, C, el, K, stride, sms,
                                        rows=rows, stages=stages)
    except gemm_plan.PlanError:
        declared = 0 if rows is None else gemm_plan.depthwise_smem(
            rows, stages or gemm_plan.DW_STAGES, el, K, stride)
        if declared <= gemm_plan.SMEM_BLOCK:
            raise
        return _refused(fam, key, declared, gemm_plan.DW_RESIDENT)
    lib = "conv1d_depthwise" if precision == "fp" else "conv1d_depthwise_quant"
    per_block = _cdiv(plan.items, plan.blocks)
    width = gemm_plan.copy_bytes(el, [0], [C])
    return KernelInstance(
        family=fam, key=key, grid=(plan.blocks, 1, 1), threads=128,
        smem=plan.smem, per_sm=plan.per_sm,
        copies=_depthwise_x(C, el, per_block * plan.stage_rows),
        out_bytes=B * lout * C * DTYPE_BYTES[dtype],
        block_ops=2.0 * per_block * plan.rows * K * plan.slab,
        ops_dtype="float32",
        smem_traffic=per_block * (plan.stage_rows + plan.rows * K)
        * plan.slab * el,
        inflight_bytes=(plan.stages - 1) * plan.smem // plan.stages,
        serial_steps=_cdiv(per_block, plan.stages - 1) + 1,
        query=(lib, f"{lib}_query", B, L, C, K, stride, lout,
               KIND[xdt] if precision != "fp" else KIND[dtype], plan.rows,
               plan.stages, plan.blocks, width),
    )


def build_conv1d_depthwise_bwd_dw(*, B, L, C, K, stride=1, dtype="float32",
                                  sms=build.DEFAULT_SMS, bwd_rows=None,
                                  bwd_stages=None, bwd_splits=None,
                                  rows=None, stages=None) -> KernelInstance:
    """Row 11 (``conv1d_depthwise_bwd_dw``): slabs × S blocks on the same
    ring, each summing its items' dw and db into a fixed-order partial,
    added by one ``reduce_splits`` pass where S > 1
    (``gemm_plan.depthwise_dw_plan``). ``rows`` and ``stages`` are the
    forward's plan, which a tuning entry holds beside this launch's and
    this launch does not take."""
    del rows, stages
    lout = (L - K) // stride + 1
    if lout < 1:
        raise ValueError(f"K={K} stride={stride} exceeds L={L}")
    el = DTYPE_BYTES[dtype]
    key = f"conv1ddw|B{B}|L{L}|C{C}|K{K}|s{stride}|{dtype}|grad"
    try:
        plan = gemm_plan.depthwise_dw_plan(B, lout, C, el, K, stride, sms,
                                           rows=bwd_rows, stages=bwd_stages,
                                           splits=bwd_splits)
    except gemm_plan.PlanError:
        declared = 0 if bwd_rows is None else gemm_plan.depthwise_dw_smem(
            bwd_rows, bwd_stages or gemm_plan.DW_STAGES, el, K, stride)
        if declared <= gemm_plan.SMEM_BLOCK:
            raise
        return _refused("conv1d_depthwise_bwd_dw", key, declared,
                        gemm_plan.DW_RESIDENT)
    per_block = _cdiv(plan.items // plan.slabs, plan.splits)
    width = gemm_plan.copy_bytes(el, [0], [C])
    return KernelInstance(
        family="conv1d_depthwise_bwd_dw", key=key,
        grid=(plan.blocks, 1, 1), threads=128, smem=plan.smem,
        per_sm=plan.per_sm,
        copies=_depthwise_x(C, el, per_block * plan.stage_rows,
                            extra=(("dz", per_block * plan.rows),)),
        out_bytes=(K + 1) * C * 4,
        block_ops=2.0 * per_block * plan.rows * (K + 1) * plan.slab,
        ops_dtype="float32",
        smem_traffic=per_block * (plan.stage_rows + plan.rows * (2 * K + 2))
        * plan.slab * el,
        inflight_bytes=(plan.stages - 1) * (plan.stage_rows + plan.rows)
        * plan.slab * el,
        serial_steps=_cdiv(per_block, plan.stages - 1) + 1,
        splits=plan.splits, partial=(K + 1) * C, workspace=plan.workspace,
        query=("conv1d_depthwise_bwd", "conv1d_depthwise_bwd_dw_query", B, L,
               C, K, stride, lout, KIND[dtype], plan.rows, plan.stages,
               plan.splits, width),
    )


def _refused(family, key, smem, per_sm) -> KernelInstance:
    """A forced plan that its plan function refused for its bytes: the
    declared shared memory, nothing launched (no query)."""
    return KernelInstance(
        family=family, key=key, grid=(1, 1, 1), threads=128, smem=smem,
        per_sm=per_sm, copies=[], out_bytes=0, block_ops=0.0, ops_dtype="float32", smem_traffic=0)


# ---------------------------------------------------------------------------
# decode attention (rows 2, 2b), pooling (rows 8, 9), the scan (row 16)
# ---------------------------------------------------------------------------

# attention_decode.cu's constants
ATTN_THREADS = 256
ATTN_MAXG = 8
ATTN_MAXTR = 64
ATTN_TILE_BYTES = 16_384


def attention_tile_rows(D: int, elem: int) -> int:
    """Cache rows a tile of ``csrc/attention_decode.cu`` stages (``TR``):
    ``ATTN_MAXTR``, halved while a tile's rows take over
    ``ATTN_TILE_BYTES``, down to 8."""
    tr = ATTN_MAXTR
    while tr > 8 and tr * D * elem > ATTN_TILE_BYTES:
        tr //= 2
    return tr


def attention_smem(G: int, D: int, elem: int, rows: int, nsplit: int) -> int:
    """``geometry(G, D, el, rows, nsplit).bytes`` of
    ``csrc/attention_decode.cu``: the two tile buffers (or the p.v pass's
    combine, the larger), q in float32 and bf16, a tile's partial scores,
    the split's scores, m/l/ticket and, split, the merge's weights."""
    row = D * elem
    tr = attention_tile_rows(D, elem)
    k = _cdiv(row, 16) * 16
    if (k // 16) % 2 == 0:
        k += 16
    qd = _cdiv(D, 8) * 8
    rg = ATTN_THREADS // ((D + 1) // 2)
    rmax = _cdiv(rows, tr) * tr
    stages, comb = 2 * tr * k, rg * G * D * 4
    off = _cdiv(max(stages, comb), 16) * 16
    off += G * qd * 4 + ATTN_MAXG * (qd + 8) * 2 + ATTN_THREADS * G * 4
    off += rmax * ATTN_MAXG * 4 + 32 * 4
    return off + (2 * G * nsplit * 4 if nsplit > 1 else 0)


def build_attention_decode(*, B, S, KV, G, D, kind="bfloat16",
                           sms=build.DEFAULT_SMS,
                           split_rows=None) -> KernelInstance:
    """Rows 2 and 2b (``attention_decode.decode_attention``): (splits,
    B·KV) blocks, each one split of a (slot, head)'s cache rows; the last
    block of a (slot, head) merges the splits' softmax state in split
    order (``decode_splits``)."""
    if G > attn_dec.MAX_G or D > attn_dec.MAX_D:
        raise ValueError(f"kernel takes G <= {attn_dec.MAX_G}, D <= "
                         f"{attn_dec.MAX_D}")
    nsplit, rows = attn_dec.decode_splits(B * KV, S, sms, rows=split_rows)
    el = DTYPE_BYTES[kind]
    per = min(rows, S)
    kv_blk = per * D * el + (per * 4 if kind == "int8" else 0)
    ws = B * KV * nsplit * G * (2 + D) if nsplit > 1 else 0
    width = gemm_plan.copy_bytes(el, [0], [D, KV * D])
    copies = [Copy("k", width, kv_blk), Copy("v", width, kv_blk),
              Copy("q", 4, G * D * 4)]
    return KernelInstance(
        family=f"attention_decode.{kind}",
        key=f"attn_dec|B{B}|S{S}|KV{KV}|G{G}|D{D}|{kind}",
        grid=(nsplit, B * KV, 1), threads=ATTN_THREADS,
        smem=attention_smem(G, D, el, rows, nsplit),
        per_sm=attn_dec.BLOCKS_PER_SM, copies=copies, out_bytes=B * KV * G * D * 4,
        block_ops=4.0 * G * per * D + 8.0 * G * per, ops_dtype="float32",
        smem_traffic=2 * kv_blk * (1 + G),
        inflight_bytes=attention_tile_rows(D, el) * D * el,
        serial_steps=2 * _cdiv(per, attention_tile_rows(D, el))
        + (1 if nsplit > 1 else 0),
        splits=nsplit, partial=B * KV * G * (2 + D), workspace=ws,
        # the last block of each (slot, head) merges its splits
        second_pass_blocks=B * KV,
        query=("attention_decode", "decode_attention_query", G, D,
               KIND[kind], rows, nsplit),
    )


def build_pool1d(*, B, L, C, window, op="max", dtype="float32",
                 sms=build.DEFAULT_SMS, method="scan") -> KernelInstance:
    """Row 8 (``sliding_pool.sliding_pool``): blocks of R outputs × CB
    channels of a batch row (``sliding_pool.pool_layout``), two an SM."""
    lout = L - window + 1
    if lout < 1:
        raise ValueError(f"window={window} exceeds L={L}")
    if op not in spool.OPS or method not in spool.METHODS:
        raise ValueError(f"no pool form for op={op!r} method={method!r}")
    form = "sum" if op != "max" else f"max_{method}"  # as sliding_pool's
    el = DTYPE_BYTES[dtype]
    lay = spool.pool_layout(B, lout, C, window, form, el, sms)
    n_rb, n_cb = _cdiv(lout, lay.rows), _cdiv(C, lay.chans)
    halo = lay.rows + window - 1
    scan = form != "max_shift"
    return KernelInstance(
        family="pool1d", key=f"pool1d|B{B}|L{L}|C{C}|w{window}|{op}|{dtype}",
        grid=(B * n_rb * n_cb, 1, 1), threads=spool.POOL_THREADS,
        smem=spool.pool_smem_bytes(form, el, lay.rows, lay.chans, lay.piece,
                                   window),
        # POOL_SMEM is sized so that two blocks share an SM
        per_sm=gemm_plan.SMEM_SM // (spool.POOL_SMEM + BLOCK_RESERVE),
        copies=[Copy("x", gemm_plan.copy_bytes(el, [0], [C, lay.chans]),
                     halo * lay.chans * el)],
        out_bytes=B * lout * C * el,
        block_ops=float(lay.chans * (4 * halo if scan
                                     else lay.rows * window)),
        ops_dtype="float32", smem_traffic=3 * halo * lay.chans * 4,
        inflight_bytes=min(lay.piece, halo) * lay.chans * el,
        serial_steps=_cdiv(halo, min(lay.piece, halo)),
        query=("sliding_pool", "sliding_pool_query",
               spool.OP_CODES[(op, method) if op == "max" else op],
               KIND[dtype], lay.rows, lay.chans, lay.piece, window),
    )


# sliding_pool.cu's max-gradient slots: SLOT_SMEM bytes a block at most
POOL_SLOT_SMEM = 200 * 1024


def _slot_bytes(lanes: int) -> int:
    return 16 + 8 if lanes == 1 else 32 + 4


def max_bwd_threads(sb: int, lanes: int, total: int, sms: int) -> int:
    """``bwd_block_threads`` of ``csrc/sliding_pool.cu``: the most threads
    (up to 256) whose slots fit ``POOL_SLOT_SMEM``, fewer while that
    leaves under two blocks an SM; 0 where even 32 threads' slots do not
    fit (they then live in global scratch)."""
    fit = POOL_SLOT_SMEM // (sb * _slot_bytes(lanes))
    if fit < 32:
        return 0
    t = spool.POOL_THREADS
    while t > 32 and (t > fit or _cdiv(total, t) < 2 * sms):
        t //= 2
    return t


def build_max_pool_bwd(*, B, L, C, window, dtype="float32",
                       sms=build.DEFAULT_SMS) -> KernelInstance:
    """Row 9 (``sliding_pool.max_pool_bwd``): groups of ``lanes`` threads,
    each (b, tile of blocks of w rows, c) (``sliding_pool.max_bwd_layout``),
    the slots in shared memory where they fit."""
    lout = L - window + 1
    if lout < 1:
        raise ValueError(f"window={window} exceeds L={L}")
    tile, lanes = spool.max_bwd_layout(B, L, C, window, sms)
    n_tiles = _cdiv(_cdiv(L, window), tile)
    total = B * n_tiles * C * lanes
    sb = _cdiv(window, lanes)
    fit = max_bwd_threads(sb, lanes, total, sms)
    threads = fit or spool.POOL_THREADS
    el = DTYPE_BYTES[dtype]
    return KernelInstance(
        family="max_pool_bwd", key=f"pool1d|B{B}|L{L}|C{C}|w{window}|max|"
                                   f"{dtype}|grad",
        grid=(_cdiv(total, threads), 1, 1), threads=threads,
        smem=threads * sb * _slot_bytes(lanes) if fit else 0, per_sm=1,
        copies=[Copy(n, el, threads * tile * window * el // lanes)
                for n in ("x", "dy")],
        out_bytes=B * L * C * el, block_ops=float(threads * 4 * window),
        ops_dtype="float32", smem_traffic=threads * sb * _slot_bytes(lanes),
        inflight_bytes=threads * 2 * el, serial_steps=tile * sb,
        query=("sliding_pool", "max_pool_bwd_query", B, L, C, window, tile,
               lanes, sms),
    )


# ssm_scan.cu: 128 d values a block, c staged 64 steps x NT lanes at a time
SSM_THREADS = 128
SSM_CH = 64


def ssm_width(N: int) -> int:
    """``compiled_width`` of ``csrc/ssm_scan.cu``: N itself up to 16, else
    the next of 24, 32, 48, 64; above 64, groups of 64."""
    return N if N <= 16 else next((w for w in (24, 32, 48) if N <= w), 64)


def build_ssm_scan(*, B, L, D, N, dtype="float32",
                   sms=build.DEFAULT_SMS) -> KernelInstance:
    """Row 16 (``ssm_scan.ssm_scan``): (D / 128, B) blocks, a thread one d
    carrying its N states through L steps; c staged in static shared
    memory."""
    del sms
    el = DTYPE_BYTES[dtype]
    nt = ssm_width(N)
    groups = _cdiv(N, nt)
    return KernelInstance(
        family="ssm_scan", key=f"ssm|B{B}|L{L}|D{D}|N{N}|{dtype}",
        grid=(_cdiv(D, SSM_THREADS), B, 1), threads=SSM_THREADS,
        smem=SSM_CH * nt * 4, per_sm=1,
        copies=[Copy("abar", el, L * SSM_THREADS * N * el),
                Copy("bx", el, L * SSM_THREADS * N * el),
                Copy("c", el, L * N * el)],
        out_bytes=B * L * D * el + B * D * N * 4,
        block_ops=4.0 * L * SSM_THREADS * N, ops_dtype="float32",
        smem_traffic=L * SSM_THREADS * N * 4 * groups,
        inflight_bytes=2 * SSM_THREADS * nt * el,
        serial_steps=groups * L,
        query=("ssm_scan", "ssm_scan_query", N),
    )


#: family -> builder; a tuning candidate's fields splat into it beside the
#: shape (``check_autotune_candidate``)
FAMILIES: dict[str, Callable[..., KernelInstance]] = {
    "conv1d": build_conv1d,
    "conv2d": build_conv2d,
    "conv1d_bwd_dw": build_conv1d_bwd_dw,
    "conv2d_bwd_dw": build_conv2d_bwd_dw,
    "matmul": build_matmul,
    "conv1d_im2col": build_conv1d_im2col,
    "conv2d_im2col": build_conv2d_im2col,
    "conv1d_depthwise": build_conv1d_depthwise,
    "conv1d_depthwise_bwd_dw": build_conv1d_depthwise_bwd_dw,
    "attention_decode": build_attention_decode,
    "pool1d": build_pool1d,
    "max_pool_bwd": build_max_pool_bwd,
    "ssm_scan": build_ssm_scan,
}

#: every launching C entry (library, symbol) -> its family and PERF.md row
LAUNCHERS: dict[tuple[str, str], tuple[str, str]] = {
    ("sliding_conv1d", "sliding_conv1d"): ("conv1d", "1"),
    ("attention_decode", "decode_attention"): ("attention_decode", "2, 2b"),
    ("conv1d_depthwise", "conv1d_depthwise"): ("conv1d_depthwise", "3"),
    ("sliding_conv2d", "sliding_conv2d"): ("conv2d", "4"),
    ("im2col_gemm", "im2col_matmul"): ("matmul", "5"),
    ("im2col_gemm", "im2col_conv1d"): ("conv1d_im2col", "6"),
    ("im2col_gemm", "im2col_conv2d"): ("conv2d_im2col", "7"),
    ("sliding_pool", "sliding_pool"): ("pool1d", "8"),
    ("sliding_pool", "max_pool_bwd"): ("max_pool_bwd", "9"),
    ("sliding_conv_bwd", "conv1d_bwd_dw"): ("conv1d_bwd_dw", "10"),
    ("conv1d_depthwise_bwd", "conv1d_depthwise_bwd_dw"):
        ("conv1d_depthwise_bwd_dw", "11"),
    ("sliding_conv2d_bwd", "conv2d_bwd_dw"): ("conv2d_bwd_dw", "12"),
    ("sliding_conv_quant", "sliding_conv_quant"): ("conv1d", "13"),
    ("sliding_conv2d_quant", "sliding_conv2d_quant"): ("conv2d", "14"),
    ("conv1d_depthwise_quant", "conv1d_depthwise_quant"):
        ("conv1d_depthwise", "15"),
    ("ssm_scan", "ssm_scan"): ("ssm_scan", "16"),
}


def check_autotune_candidate(family: str, shape: dict, cand: dict, *,
                             budget: int | None = None) -> Violation | None:
    """The first contract violation of one tuning candidate, or None.

    The hook ``kernels/autotune.py`` calls before it times a candidate: a
    plan that provably breaks a limit is pruned instead of timed. The
    builder declares a forced plan's shared memory before its plan
    function is asked, so a plan refused for its bytes is reported here
    (``smem_budget``). An unknown family, or a candidate that is no plan
    at all (a field the builder does not take, a value its plan function
    refuses on other grounds), gives None: the search then meets the
    plan function's own refusal."""
    builder = FAMILIES.get(family)
    if builder is None:
        return None
    try:
        inst = builder(**shape, **cand)
    except (TypeError, ValueError):
        return None
    vio = check_instance(inst, budget=budget)
    return vio[0] if vio else None


# ---------------------------------------------------------------------------
# the key space: the reference's shapes and the port's full-width model
# shapes × the tuning candidates
# ---------------------------------------------------------------------------

# the reference's (repro.analysis.contracts)
FIG1 = dict(H=128, W=128, C=32, ks=(2, 3, 4, 5, 7, 9, 11, 13, 17, 19, 23, 27,
                                    31))
FIG2 = dict(H=96, W=96, C=32, ks=(3, 5, 9, 13, 17, 25, 31))
CONV1D = dict(L=16384, C=32, ks=(2, 3, 5, 9, 17, 33, 65))
ATTN = dict(B=2, S=2048, KV=2, G=2, D=32)
SSM = dict(B=2, L=512, D=1024, N=16)

# the port's model paths at full width (chip_smoke.py drives them)
# whisper-medium's frontend at P=256 (2P mel frames, SAME padding adds 2
# rows), and its decode read at S=288
CONV_MAIN = {
    "conv1": dict(B=4, L=514, Cin=80, Cout=1024, K=3, stride=1),
    "conv2": dict(B=4, L=514, Cin=1024, Cout=1024, K=3, stride=2),
}
ATTN_MAIN = dict(B=4, S=288, KV=16, G=1, D=64)
# jamba-1.5-large's Mamba conv at prefill (P=256, K-1 causal rows) and in
# training (B 2 x 512), and its decode read
DEPTHWISE_MAIN = dict(B=4, L=259, C=16384, K=4, stride=1)
DEPTHWISE_TRAIN = dict(B=2, L=515, C=16384, K=4, stride=1)
ATTN_JAMBA = dict(B=4, S=288, KV=8, G=8, D=128)
# jamba's selective scan over one chunk
SCAN_MAIN = dict(B=4, L=256, D=16384, N=16)
# llava-next-34b's patch embedding (anyres: 5 tiles of 336 x 336 a slot,
# 4 slots) and its decode read over 5 x 576 patches + prompt + tokens
PATCH_MAIN = dict(B=20, H=336, W=336, Cin=3, Cout=1152, k=14, stride=14)
ATTN_LLAVA = dict(B=4, S=3168, KV=8, G=7, D=128)
# gemma-2b (one kv head of D 256), qwen3-moe-30b-a3b, the GQA-4 decoders
ATTN_GEMMA = dict(B=4, S=288, KV=1, G=8, D=256)
ATTN_QWEN_MOE = dict(B=4, S=288, KV=4, G=8, D=128)
ATTN_GQA4 = dict(B=4, S=288, KV=8, G=4, D=128)
# the rank-local launches of the mesh runs (chip_smoke.py phase 53): each
# model rank's query and KV heads at a cache of P 256 + 9 tokens, and
# mamba's prefill conv on its 8,192 of 16,384 channels (model 2)
ATTN_QWEN3_TP2 = dict(B=4, S=265, KV=4, G=2, D=128)  # qwen3-1.7b
ATTN_JAMBA_TP2 = dict(B=4, S=265, KV=4, G=8, D=128)  # jamba-1.5-large
ATTN_QWEN_MOE_TP2 = dict(B=2, S=265, KV=2, G=8, D=128)  # qwen3-moe, data 2
DEPTHWISE_TP2 = dict(DEPTHWISE_MAIN, C=8192)
# the tuning shapes: the reference benchmark's autotune rows (f32 fig1 k
# 3/9/31, fig2 k 3/17, conv1d K 3/33 fp and w8a8, max pool w 4/256) and
# the int8 decode read at qwen3's smoke cache
TUNE_FIGS = (("fig1", 128, (3, 9, 31)), ("fig2", 96, (3, 17)))
TUNE_CONV1D = dict(B=1, L=16384, C=32, Ks=(3, 33))
TUNE_POOL_WINDOWS = (4, 256)
TUNE_ATTN_INT8 = dict(B=2, S=2048, KV=2, G=2, D=32)

POOL_WINDOWS = (4, 16, 64, 256)


def _gemm_cands(M, N, K, adt, sms):
    from repro_torch.kernels import autotune

    default, cands = autotune.gemm_candidates(M, N, K, TORCH_DTYPES[adt],
                                              sms)
    return [default] + [c for c in cands if c != default]


def default_space(quick: bool = False,
                  sms: int = build.DEFAULT_SMS
                  ) -> Iterator[tuple[str, dict, dict]]:
    """(family, shape, candidate) triples: every family at the reference's
    shapes and the port's full-width shapes × the port's tuning
    candidates (``autotune.gemm_candidates``, ``depthwise_candidates``,
    ``depthwise_dw_candidates``, ``attention_candidates``) and the rule's
    plan."""
    from repro_torch.kernels import autotune

    fp = ("float32", "bfloat16")
    precisions = (("fp", "float32"), ("fp", "bfloat16"), ("w8a8", "float32"),
                  ("w8a16", "float32"), ("w8a16", "bfloat16"))

    def conv2d(shape, precs):
        oh = (shape["H"] - shape["kh"]) // shape["stride"][0] + 1
        ow = (shape["W"] - shape["kw"]) // shape["stride"][1] + 1
        for prec, dt in precs:
            adt = _precision_types(prec, dt)[0]
            s = dict(shape, precision=prec, dtype=dt, sms=sms)
            for c in _gemm_cands(shape["B"] * oh * ow, shape["Cout"],
                                 shape["kh"] * shape["kw"] * shape["Cin"],
                                 adt, sms):
                yield "conv2d", s, c

    def conv1d(shape, precs):
        lout = (shape["L"] - shape["K"]) // shape["stride"] + 1
        for prec, dt in precs:
            adt = _precision_types(prec, dt)[0]
            s = dict(shape, precision=prec, dtype=dt, sms=sms)
            for c in _gemm_cands(shape["B"] * lout, shape["Cout"],
                                 shape["K"] * shape["Cin"], adt, sms):
                yield "conv1d", s, c

    figs = [FIG1] if quick else [FIG1, FIG2]
    for fig in figs:
        h, c = fig["H"], fig["C"]
        for k in (fig["ks"][:3] + fig["ks"][-1:] if quick else fig["ks"]):
            shape = dict(B=1, H=h, W=h, Cin=c, Cout=c, kh=k, kw=k,
                         stride=(1, 1))
            yield from conv2d(shape, precisions)
            for dt in fp:
                for cand in _gemm_cands(k * k * c, c, (h - k + 1) ** 2, dt,
                                        sms):
                    yield "conv2d_bwd_dw", dict(shape, dtype=dt,
                                                sms=sms), cand
            yield "conv2d_im2col", dict(shape, dtype="float32", sms=sms), {}
    p = PATCH_MAIN
    patch = dict(B=p["B"], H=p["H"], W=p["W"], Cin=p["Cin"], Cout=p["Cout"],
                 kh=p["k"], kw=p["k"], stride=(p["stride"], p["stride"]))
    yield from conv2d(patch, (("fp", "bfloat16"), ("w8a8", "bfloat16"),
                              ("w8a16", "bfloat16")))
    n = (p["H"] // p["k"]) ** 2 * p["B"]
    for cand in _gemm_cands(p["k"] ** 2 * p["Cin"], p["Cout"], n, "bfloat16",
                            sms):
        yield "conv2d_bwd_dw", dict(patch, dtype="bfloat16", sms=sms), cand
    yield "conv2d_im2col", dict(patch, dtype="bfloat16", sms=sms), {}

    L, c = CONV1D["L"], CONV1D["C"]
    for k in (CONV1D["ks"][:3] + CONV1D["ks"][-2:] if quick
              else CONV1D["ks"]):
        shape = dict(B=1, L=L, Cin=c, Cout=c, K=k, stride=1)
        yield from conv1d(shape, precisions)
        for cand in _gemm_cands(k * c, c, L - k + 1, "float32", sms):
            yield "conv1d_bwd_dw", dict(shape, dtype="float32", sms=sms), cand
        yield "conv1d_im2col", dict(shape, dtype="float32", sms=sms), {}
    for s in CONV_MAIN.values():
        yield from conv1d(s, precisions)
        lout = (s["L"] - s["K"]) // s["stride"] + 1
        for dt in fp:
            for cand in _gemm_cands(s["K"] * s["Cin"], s["Cout"],
                                    s["B"] * lout, dt, sms):
                yield "conv1d_bwd_dw", dict(s, dtype=dt, sms=sms), cand
            yield "conv1d_im2col", dict(s, dtype=dt, sms=sms), {}
            yield "matmul", dict(M=s["B"] * lout, N=s["Cout"],
                                 K=s["K"] * s["Cin"], dtype=dt, sms=sms), {}

    dw_shapes = [dict(B=2, L=4096, C=512, K=4, stride=1), DEPTHWISE_MAIN,
                 DEPTHWISE_TP2]
    for s in dw_shapes:
        lout = (s["L"] - s["K"]) // s["stride"] + 1
        for prec, dt in (("fp", "bfloat16"), ("fp", "float32"),
                         ("w8a8", "bfloat16"), ("w8a16", "bfloat16")):
            el = 1 if prec == "w8a8" else DTYPE_BYTES[dt]
            default, cands = autotune.depthwise_candidates(
                s["B"], lout, s["C"], el, s["K"], s["stride"], sms)
            for cand in [default] + [c for c in cands if c != default]:
                yield "conv1d_depthwise", dict(s, precision=prec, dtype=dt,
                                               sms=sms), cand
    for s in (dict(B=2, L=4096, C=512, K=4, stride=1), DEPTHWISE_TRAIN):
        lout = (s["L"] - s["K"]) // s["stride"] + 1
        for dt in fp:
            default, cands = autotune.depthwise_dw_candidates(
                s["B"], lout, s["C"], DTYPE_BYTES[dt], s["K"], s["stride"],
                sms)
            if quick:
                cands = cands[::8]
            for cand in [default] + [c for c in cands if c != default]:
                yield "conv1d_depthwise_bwd_dw", dict(s, dtype=dt,
                                                      sms=sms), cand

    attn = [ATTN, TUNE_ATTN_INT8, ATTN_MAIN, ATTN_LLAVA, ATTN_GEMMA]
    if not quick:
        attn += [ATTN_JAMBA, ATTN_QWEN_MOE, ATTN_GQA4, ATTN_QWEN3_TP2,
                 ATTN_JAMBA_TP2, ATTN_QWEN_MOE_TP2]
    for s in attn:
        default, cands = autotune.attention_candidates(s["B"] * s["KV"],
                                                       s["S"], sms)
        for kind in ("float32", "bfloat16", "int8"):
            for cand in [default] + [c for c in cands if c != default]:
                yield "attention_decode", dict(s, kind=kind, sms=sms), cand

    pools = [dict(B=1, L=16384, C=32, window=w) for w in POOL_WINDOWS]
    pools.append(dict(B=8, L=16384, C=1024, window=16))
    for s in pools[:2] if quick else pools:
        for dt in fp:
            for op, method in (("sum", "scan"), ("avg", "scan"),
                               ("max", "scan"), ("max", "shift")):
                yield "pool1d", dict(s, op=op, dtype=dt, sms=sms), {
                    "method": method}
            yield "max_pool_bwd", dict(s, dtype=dt, sms=sms), {}
    for s in (SSM, SCAN_MAIN):
        for dt in fp:
            yield "ssm_scan", dict(s, dtype=dt, sms=sms), {}


def instances(quick: bool = False, sms: int = build.DEFAULT_SMS
              ) -> Iterator[tuple[str, dict, dict, KernelInstance]]:
    """(family, shape, candidate, instance) over the key space."""
    for family, shape, cand in default_space(quick=quick, sms=sms):
        yield family, shape, cand, FAMILIES[family](**shape, **cand)


def check_all(*, quick: bool = False, budget: int | None = None,
              sms: int = build.DEFAULT_SMS) -> tuple[list[Violation], dict]:
    """Check every family over the key space: (violations, stats)."""
    budget = smem_budget() if budget is None else budget
    violations: list[Violation] = []
    checked, families, most = 0, set(), 0
    for _, _, _, inst in instances(quick=quick, sms=sms):
        families.add(inst.family)
        checked += 1
        most = max(most, inst.smem)
        violations.extend(check_instance(inst, budget=budget))
    stats = {"instances": checked, "families": sorted(families),
             "smem_budget": budget, "smem_max": most, "sms": sms}
    return violations, stats


def launcher_query(inst: KernelInstance) -> tuple[int, int]:
    """The launcher's own (dynamic shared memory, threads) for this
    instance, from its query entry in the built library (nothing is
    launched). Raises where the launcher refuses the plan."""
    import ctypes

    lib, sym, *args = inst.query
    fn = build.entry(lib, sym, [ctypes.c_int] * len(args)
                     + [ctypes.POINTER(ctypes.c_int)] * 2)
    smem, threads = ctypes.c_int(), ctypes.c_int()
    build.check(lib, fn(*args, ctypes.byref(smem), ctypes.byref(threads)))
    return smem.value, threads.value
