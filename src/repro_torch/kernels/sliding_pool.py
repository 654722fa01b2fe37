"""Sliding-window pooling along L and its gradient (``repro.kernels.sliding_pool``).

  * ``sliding_pool``: VALID pooling of x (B, L, C) into (B, L - w + 1, C)
    in x's type. sum/avg: a float32 prefix over each block's halo of
    R + w - 1 rows, then the strided difference, cast to x's type (avg
    then divides that already-cast sum by w in float32 and casts again).
    max: the van Herk / Gil-Werman block prefix/suffix max (``method``
    "scan") or the shift-and-max loop ("shift"); both exact.
  * ``sum_pool_bwd``: dx of sum pooling, the forward sum on dy padded by
    w - 1 zero rows on both sides.
  * ``max_pool_bwd``: dx of max pooling in one launch: per window the
    tie count cnt = #{m < w : x[i+m] == y[i]} and the split dy / max(cnt,
    1), rounded to dy's type; then dx[j] = sum_k dys[j-k] * [x[j] == y[j-k]]
    over the windows that exist, summed in float32, one cast to x's type.
    Each window's gradient is shared evenly by its tied maxima. The kernel
    is O(n) a channel: blocks of w rows, runs of equal suffix and prefix
    maxima, running sums over them (``csrc/sliding_pool.cu``); y must be
    x's sliding max, as ``sliding_pool(x, op="max")`` gives it.

Each wrapper launches its Hopper kernel (``csrc/sliding_pool.cu``) on a
CUDA tensor and runs its plain version (``sliding_pool_plain``,
``sum_pool_bwd_plain``, ``max_pool_bwd_plain``: the kernel bodies'
arithmetic in torch) on a CPU tensor. Any other device raises; nothing falls
back from the kernel to the plain version. The kernels take float32 or
bfloat16; another type raises ``TypeError`` on the card (the plain versions
also pool other types, int8 codes included). Launch counters:
``sliding_pool.launches`` (and per form ``launches_sum``, ``launches_avg``,
``launches_max_scan``, ``launches_max_shift``), ``sum_pool_bwd.launches``,
``max_pool_bwd.launches`` (one a call).

The forward's layout (``pool_layout``) comes from the shape, the form and
the card (``build.sm_count``): a block of ``POOL_THREADS`` threads owns R
output rows of one batch row and CB channels (a power of two up to 32, the
lanes; the threads' groups split the rows), stages their halo of R + w - 1
rows in shared memory, and, where the halo does not fit ``POOL_SMEM``,
streams it through stages of P rows. The sum's float32 prefix runs over
the halo in runs of Q rows, each summed in sequence, then the runs' totals
carried in run order. The plain version walks the same layout in the same
order (on the CPU, that of an H100's 132 SMs), so sum and avg agree with
the kernel bit for bit on the card; the max forms are exact either way.
The max gradient's layout (``max_bwd_layout``): the blocks of w rows a
group of threads walks, and the threads (lanes) that share each block
when the shape gives few blocks.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core.sliding import _extreme
from repro_torch.kernels import build, gemm_plan

OPS = ("sum", "avg", "max")
METHODS = ("scan", "shift")
OP_CODES = {"sum": 0, "avg": 1, ("max", "scan"): 2, ("max", "shift"): 3}
# threads that keep an SM busy (half of what it can hold): the max
# gradient's sizing
THREADS_PER_SM = 1024
# the forward: threads a block, the most shared memory its stage takes (two
# blocks an SM at least), the most output rows a block and the fewest it is
# cut to before its halo streams
POOL_THREADS = 256
POOL_SMEM = 96 * 1024
MAX_ROWS, FIT_ROWS = 256, 32
# the fewest rows of a block a lane of the max gradient takes when lanes
# share a block (fewer rows, more of its time goes to the lanes' shuffles)
MIN_LANE_ROWS = 16
# x, y; B, L, lead, Lsrc, C, window, Lout, rows, chans, run, piece, copy,
# op, is_bf16; stream
_POOL_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 14
                  + [ctypes.c_void_p])
# x, dy, dx, scratch; B, L, C, window, Lout, tile, lanes, sms, is_bf16;
# stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# the forward's forms: sum and avg share the kernel's layout
FORMS = ("sum", "max_scan", "max_shift")


@dataclass(frozen=True)
class PoolLayout:
    """A forward block: ``rows`` outputs (R) and ``chans`` channels (CB) of
    one batch row, its halo of R + w - 1 rows staged ``piece`` rows (P) at
    a time (one stage where P covers the halo), the sum's prefix in runs of
    ``run`` rows (Q)."""
    rows: int
    chans: int
    run: int
    piece: int

    @property
    def groups(self) -> int:
        """Thread groups a block: they split the rows."""
        return POOL_THREADS // self.chans

    def streamed(self, window: int) -> bool:
        return self.piece < self.rows + window - 1


def _line16(n: int) -> int:
    return -(-n // 16) * 16


def pool_smem_bytes(form: str, elem: int, rows: int, chans: int, piece: int,
                    window: int) -> int:
    """Shared memory of one forward block (``csrc/sliding_pool.cu``'s
    pool_smem): the stage of min(P, H) rows and, for the sum, its float32
    prefix, the runs' totals and, streamed, S[i-1] of the outputs; for the
    scan its suffix maxima or, streamed, two R-row blocks and the groups'
    maxima; for the shift form, streamed, its running maxima. Each array
    is a whole number of 16-byte lines."""
    H = rows + window - 1
    ps, streamed = min(piece, H), piece < H
    G = POOL_THREADS // chans
    if form == "sum":
        return ((0 if elem == 4 else _line16(ps * chans * elem))
                + _line16(ps * chans * 4) + _line16(G * chans * 4)
                + (_line16(rows * chans * 4) if streamed else 0))
    if form == "max_scan":
        if streamed:
            return (2 * _line16(rows * chans * elem)
                    + _line16(ps * chans * elem) + _line16(G * chans * 4))
        return _line16(H * chans * elem) + _line16(rows * chans * elem)
    if form == "max_shift":
        return (_line16(ps * chans * elem)
                + (_line16(rows * chans * 4) if streamed else 0))
    raise ValueError(f"unknown pool form {form!r}; one of {FORMS}")


def _chans(C: int) -> int:
    """Channels a forward block: the lanes, C rounded up to a power of two,
    at most 32."""
    return min(32, 1 << (C - 1).bit_length())


def _run_rows(halo: int, chans: int) -> int:
    """Q over a whole halo: about its root (so a thread's run and the
    carry's fold are both short), at most one run a thread group; odd
    where a warp spans several groups (CB < 32), so that their rows fall
    in different banks."""
    runs = min(POOL_THREADS // chans, math.isqrt(halo - 1) + 1)
    run = -(-halo // runs)
    return run | 1 if chans < 32 else run


def pool_layout(B: int, n_out: int, C: int, window: int, form: str,
                elem: int, sms: int = build.DEFAULT_SMS) -> PoolLayout:
    """The forward's layout for ``n_out`` outputs of B·C sequences in
    elements of ``elem`` bytes, form "sum" (also avg), "max_scan" or
    "max_shift", on a card of ``sms`` SMs. R: the largest power of two up
    to ``MAX_ROWS`` that still gives two blocks an SM (never above
    ``n_out``), halved down to ``FIT_ROWS`` while the halo's stage does not
    fit ``POOL_SMEM``; if it still does not, the first R stays and the halo
    streams through the largest stage that fits (the scan then takes R <=
    w)."""
    chans = _chans(C)
    G = POOL_THREADS // chans
    per = B * -(-C // chans)
    rows = MAX_ROWS
    while rows > 1 and per * -(-n_out // rows) < 2 * sms:
        rows //= 2
    rows = min(rows, n_out)

    def fits(r):
        return pool_smem_bytes(form, elem, r, chans, r + window - 1,
                               window) <= POOL_SMEM

    fit = rows
    while fit > FIT_ROWS and not fits(fit):
        fit //= 2
    if fits(fit):
        halo = fit + window - 1
        return PoolLayout(fit, chans, _run_rows(halo, chans), halo)
    if form == "max_scan":
        rows = min(rows, window)
    # the largest stage that fits; the sum's a whole number of runs, one a
    # thread group
    piece = POOL_SMEM // (chans * elem)
    while pool_smem_bytes(form, elem, rows, chans, piece, window) > POOL_SMEM:
        piece -= 1
    run = piece
    if form == "sum":
        run = piece // G
        if chans < 32 and run % 2 == 0:
            run -= 1
        piece = run * G
    return PoolLayout(rows, chans, run, piece)


def max_bwd_layout(B: int, L: int, C: int, window: int,
                   sms: int = build.DEFAULT_SMS) -> tuple[int, int]:
    """(tile, lanes) of the max-gradient kernel on a card of ``sms`` SMs:
    each group of ``lanes`` threads walks ``tile`` blocks of ``window``
    rows of one channel, lane k the k-th share of each block. Where
    B·C·blocks alone give fewer than half of ``THREADS_PER_SM`` an SM, a
    block is shared by up to 32 lanes (a power of two, each lane at least
    ``MIN_LANE_ROWS`` rows) until they give about that many, one block a
    group; otherwise one lane, and the smallest power-of-two tile that
    keeps the thread count within ``THREADS_PER_SM`` an SM."""
    target = sms * THREADS_PER_SM
    blocks = -(-L // window)
    lanes = 1
    while (lanes < 32 and 2 * lanes * MIN_LANE_ROWS <= window
           and B * C * blocks * lanes < target // 2):
        lanes *= 2
    if lanes > 1:
        return 1, lanes
    tile = 1
    while tile < blocks and B * C * -(-blocks // tile) > target:
        tile *= 2
    return min(tile, blocks), 1


def _check(x, window, op, method) -> int:
    if x.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)} is not (B, L, C)")
    if op not in OPS:
        raise ValueError(f"unknown pool op {op!r}; one of {OPS}")
    if method not in METHODS:
        raise ValueError(f"unknown pool method {method!r}; one of {METHODS}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out_len = x.shape[1] - window + 1
    if out_len < 1:
        raise ValueError(f"window {window} exceeds length {x.shape[1]}")
    return out_len


def _kernel_dtype(*ts) -> bool:
    dt = ts[0].dtype
    if dt not in (torch.float32, torch.bfloat16) or any(
            t.dtype != dt for t in ts):
        raise TypeError("pool kernels take float32 or bfloat16 tensors of "
                        f"one type, got {[t.dtype for t in ts]}")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("tensors must lie on one device")
    return dt == torch.bfloat16


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _halos(x, window, tile, fill):
    """The blocks' halos of x: (B, n_blocks, C, tile + w - 1), x padded past
    its end with ``fill`` to whole blocks of ``tile`` outputs."""
    B, L, C = x.shape
    n_tiles = -(-(L - window + 1) // tile)
    need = n_tiles * tile + window - 1
    if need > L:
        x = F.pad(x, (0, 0, 0, need - L), value=fill)
    return x.unfold(1, tile + window - 1, tile)


def _untile(t, out_len):
    """(B, n_tiles, C, tile) -> (B, out_len, C)."""
    B, nt, C, tile = t.shape
    return t.permute(0, 1, 3, 2).reshape(B, nt * tile, C)[:, :out_len]


def _halo_prefix(halo, run):
    """The kernel's float32 prefix over each halo (..., H): runs of ``run``
    rows from the first, each summed in sequence (a loop over a run's
    rows, every run at once), then the runs' totals carried in run order
    (c_0 = 0, c_{q+1} = c_q + total of run q), S = c_q + p."""
    H = halo.shape[-1]
    n_runs = -(-H // run)
    runs = F.pad(halo, (0, n_runs * run - H)).unflatten(-1, (n_runs, run))
    p = torch.empty_like(runs)
    acc = torch.zeros_like(runs[..., 0])
    for t in range(run):
        acc = acc + runs[..., t]
        p[..., t] = acc
    carry = torch.zeros_like(runs[..., 0, 0])
    for q in range(n_runs):
        total = p[..., q, run - 1].clone()
        p[..., q, :] = carry[..., None] + p[..., q, :]
        carry = carry + total
    return p.flatten(-2)[..., :H]


def sliding_pool_plain(x: torch.Tensor, *, window: int, op: str = "sum",
                       method: str = "scan", tile: int | None = None,
                       run: int | None = None):
    """The kernel's function in plain torch, block by block as the kernel
    walks it: ``tile`` outputs a block (R) and, for sum and avg, the
    prefix in runs of ``run`` rows (Q), both from ``pool_layout`` of the
    shape by default (``run`` then from R alone if only ``tile`` is
    given)."""
    out_len = _check(x, window, op, method)
    B, L, C = x.shape
    form = "sum" if op in ("sum", "avg") else f"max_{method}"
    if tile is None:
        lay = pool_layout(B, out_len, C, window, form, x.element_size(),
                          build.sm_count(x.device))
        tile, run = lay.rows, run or lay.run
    tile = min(tile, out_len)
    if op in ("sum", "avg"):
        if run is None:
            run = _run_rows(tile + window - 1, _chans(C))
        s = _halo_prefix(_halos(x.float(), window, tile, 0.0), run)
        upper = s[..., window - 1 : window - 1 + tile]
        lower = F.pad(s[..., : tile - 1], (1, 0))
        y = _untile(upper - lower, out_len).to(x.dtype)
        if op == "avg":  # a true divide, as the kernel's (not a reciprocal)
            w = torch.full((), float(window), device=x.device)
            y = (y.float() / w).to(x.dtype)
        return y
    if method == "shift":
        acc = x[:, :out_len]
        for k in range(1, window):
            acc = torch.maximum(acc, x[:, k : k + out_len])
        return acc.clone() if window == 1 else acc
    lowest = _extreme(x.dtype, lo=True)  # -inf, or an int type's minimum
    halo = _halos(x, window, tile, lowest)
    H = tile + window - 1
    nb = -(-H // window)
    if nb * window > H:
        halo = F.pad(halo, (0, nb * window - H), value=lowest)
    blocks = halo.reshape(*halo.shape[:3], nb, window)
    pre = torch.cummax(blocks, dim=-1).values.flatten(-2)
    suf = torch.cummax(blocks.flip(-1), dim=-1).values.flip(-1).flatten(-2)
    y = torch.maximum(suf[..., :tile], pre[..., window - 1 : window - 1 + tile])
    return _untile(y, out_len)


def sum_pool_bwd_plain(dy: torch.Tensor, *, window: int) -> torch.Tensor:
    """dx of sum pooling: the sum pool of dy padded by w - 1 zero rows on
    both sides (length L = out_len + w - 1)."""
    dyp = F.pad(dy, (0, 0, window - 1, window - 1))
    return sliding_pool_plain(dyp, window=window, op="sum")


def max_pool_bwd_plain(x, y, dy, *, window: int) -> torch.Tensor:
    """The kernels' function in plain torch: each window's tie count and
    its dy split over the ties (float32, rounded to dy's type), then the
    scatter onto the argmaxes in window order (k = 0 .. w-1), float32
    sums, one cast to x's type."""
    _check_bwd(x, y, dy, window)
    out_len = y.shape[1]
    cnt = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
    for m in range(window):
        cnt += (x[:, m : m + out_len] == y).float()
    dys = (dy.float() / cnt.clamp(min=1.0)).to(dy.dtype).float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(window):  # input rows j = win + k of window win
        hit = x[:, k : k + out_len] == y
        acc[:, k : k + out_len] += torch.where(hit, dys, 0.0)
    return acc.to(x.dtype)


def _check_bwd(x, y, dy, window) -> None:
    if x.dim() != 3 or y.dim() != 3 or dy.shape != y.shape:
        raise ValueError(f"x {tuple(x.shape)}, y {tuple(y.shape)}, dy "
                         f"{tuple(dy.shape)} are not (B, L, C) and two "
                         "(B, L - w + 1, C)")
    B, L, C = x.shape
    if window < 1 or y.shape != (B, L - window + 1, C):
        raise ValueError(f"y {tuple(y.shape)} is not the window-{window} "
                         f"pool of x {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _pool_kernel(x, window, code, form, lead, L, out_len):
    """One launch of the forward kernel (op ``code``, laid out for
    ``form``) on the (zero-padded, lead rows before x) sequence of length
    L; returns y (B, out_len, C)."""
    is_bf16 = _kernel_dtype(x)
    fn = build.entry("sliding_pool", "sliding_pool", _POOL_ARGTYPES)
    x = x.contiguous()
    B, Lsrc, C = x.shape
    lay = pool_layout(B, out_len, C, window, form, x.element_size(),
                      build.sm_count(x.device))
    copy = gemm_plan.copy_bytes(x.element_size(), [x.data_ptr()],
                                [C, lay.chans])
    y = torch.empty((B, out_len, C), dtype=x.dtype, device=x.device)
    code_ = fn(x.data_ptr(), y.data_ptr(), B, L, lead, Lsrc, C, window,
               out_len, lay.rows, lay.chans, lay.run, lay.piece, copy, code,
               int(is_bf16), _stream(x))
    build.check("sliding_pool", code_)
    return y


def _launch(x, window, op, method, out_len):
    code = OP_CODES[op] if op != "max" else OP_CODES[(op, method)]
    y = _pool_kernel(x, window, code, "sum" if op != "max" else
                     f"max_{method}", 0, x.shape[1], out_len)
    sliding_pool.launches += 1
    form = op if op != "max" else f"max_{method}"
    setattr(sliding_pool, f"launches_{form}",
            getattr(sliding_pool, f"launches_{form}") + 1)
    return y


def _launch_sum_bwd(dy, window):
    L = dy.shape[1] + window - 1
    dx = _pool_kernel(dy, window, OP_CODES["sum"], "sum", window - 1,
                      L + window - 1, L)
    sum_pool_bwd.launches += 1
    return dx


@functools.lru_cache(maxsize=64)
def _bwd_scratch(B, L, C, window, tile, lanes, sms) -> int:
    """float32 global scratch the gradient kernel needs (0: its slots fit
    in shared memory)."""
    fn = build.library("sliding_pool").max_pool_bwd_scratch
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    return fn(B, L, C, window, tile, lanes, sms)


def _launch_max_bwd(x, y, dy, window):
    is_bf16 = _kernel_dtype(x, y, dy)
    fn = build.entry("sliding_pool", "max_pool_bwd", _BWD_ARGTYPES)
    x, dy = x.contiguous(), dy.contiguous()
    B, L, C = x.shape
    sms = build.sm_count(x.device)
    tile, lanes = max_bwd_layout(B, L, C, window, sms)
    n = _bwd_scratch(B, L, C, window, tile, lanes, sms)
    scratch = (torch.empty(n, dtype=torch.float32, device=x.device)
               if n else None)
    dx = torch.empty_like(x)
    code = fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
              None if scratch is None else scratch.data_ptr(), B, L, C,
              window, y.shape[1], tile, lanes, sms, int(is_bf16),
              _stream(x))
    build.check("sliding_pool", code)
    max_pool_bwd.launches += 1
    return dx


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def sliding_pool(x: torch.Tensor, *, window: int, op: str = "sum",
                 method: str = "scan") -> torch.Tensor:
    """VALID sliding pooling along axis 1. x: (B, L, C) -> (B, L-w+1, C):
    the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor.
    ``method`` selects the max evaluation ("scan" | "shift"); sum/avg
    always scan."""
    out_len = _check(x, window, op, method)
    if x.device.type == "cuda":
        return _launch(x, window, op, method, out_len)
    if x.device.type == "cpu":
        return sliding_pool_plain(x, window=window, op=op, method=method)
    raise ValueError(f"no sliding_pool for device {x.device}")


def sum_pool_bwd(dy: torch.Tensor, *, window: int) -> torch.Tensor:
    """dx of sum pooling: the forward sum kernel over dy padded by w - 1
    zero rows on both sides (read in place, no padded copy on the card)."""
    if dy.dim() != 3 or window < 1:
        raise ValueError(f"dy {tuple(dy.shape)} is not (B, L - w + 1, C) "
                         f"or window {window} < 1")
    if dy.device.type == "cuda":
        return _launch_sum_bwd(dy, window)
    if dy.device.type == "cpu":
        return sum_pool_bwd_plain(dy, window=window)
    raise ValueError(f"no sum_pool_bwd for device {dy.device}")


def max_pool_bwd(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor, *,
                 window: int) -> torch.Tensor:
    """dx of max pooling. x: (B, L, C) the forward input, y/dy: (B,
    L-w+1, C) the forward output and upstream gradient (dy of x's type on
    the card; y must be x's sliding max: the kernel does not read it).
    Each window's gradient is split evenly across its tied maxima."""
    _check_bwd(x, y, dy, window)
    if x.device.type == "cuda":
        return _launch_max_bwd(x, y, dy, window)
    if x.device.type == "cpu":
        return max_pool_bwd_plain(x, y, dy, window=window)
    raise ValueError(f"no max_pool_bwd for device {x.device}")


sliding_pool.launches = 0
sliding_pool.launches_sum = 0
sliding_pool.launches_avg = 0
sliding_pool.launches_max_scan = 0
sliding_pool.launches_max_shift = 0
sum_pool_bwd.launches = 0
max_pool_bwd.launches = 0
