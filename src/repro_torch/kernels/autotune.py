"""Shape-keyed tuning of the port's launch plans, measured on the card.

The port's kernels take their launch plan from Python: the product tile
and split-K of the GEMM-shaped rows (``gemm_plan.gemm_plan``), the item
length, ring depth and split of the depthwise rows
(``gemm_plan.depthwise_plan``, ``depthwise_dw_plan``), the split length
of decode attention (``attention_decode.decode_splits``) and the max-pool
evaluation. Each plan function has a rule, and each takes its choices
forced. This module times forced plans for a concrete call shape on the
card and keeps the winner in a JSON cache that ``repro_torch.kernels.ops``
consults at every launch (explicit plan → tuned entry → the rule), as
``repro.kernels.autotune`` does for its Pallas tiles: the keys, the cache
semantics, ``_search`` and the seven searches are the reference's.

Cache format: a JSON object mapping the reference's shape keys to the
port's plan fields, each entry with the winner's card time ``us`` and the
rule's ``default_us`` (microseconds a call)::

    {
      "__schema__": 1,
      "__card__": {"name": <torch.cuda.get_device_name>, "sms": <SMs>},
      "conv1d|B4|L514|Cin1024|Cout1024|K3|s2|bfloat16":
          {"tile": "mma", "splits": 4, "us": ..., "default_us": ...},
      "conv1ddw|B2|L515|C16384|K4|s1|bfloat16":
          {"rows": 32, "stages": 2, "bwd_rows": 32, "bwd_stages": 3,
           "bwd_splits": 6, "us": ..., "default_us": ...},
      "attn_dec|B4|S3168|KV8|G7|D128|bfloat16": {"split_rows": 256, ...},
      "pool1d|B1|L16384|C32|w4|max|float32": {"method": "shift", ...}
    }

The path is ``$REPRO_TORCH_AUTOTUNE_CACHE`` (default
``.cache/autotune_cuda.json`` under the working directory), never the
reference's file: the two packages tune different fields. The variable is
read when the cache is first loaded and again after ``invalidate()`` (the
reference reads it at every lookup): a launch pays a dict lookup. ``__card__``
records the card and its SM count at each write (the rules plan from the
SM count); nothing reads it back. A file that fails to parse or carries
another ``__schema__`` is quarantined to ``<name>.corrupt`` with a
reason-coded health event, as the reference's is (the ``autotune_corrupt``
fault forces that on a sound file); a file with no ``__schema__`` is
accepted. Writes go through a per-process temporary
file and a rename.

The search times the default first, so ``us`` never exceeds
``default_us``. Each search hands ``_search`` two hooks from
``repro_torch.analysis``, as the reference's do: the launch contract
(``contracts.check_autotune_candidate``), on whose verdict a candidate
that provably breaks a limit of the card is pruned untimed, and the H100
roofline (``costmodel.candidate_cost``), by which the candidates are timed
best-predicted-first until ``COST_PATIENCE`` in a row fail to improve on
the best time. The default is never pruned. ``REPRO_TORCH_AUTOTUNE_COST=0``
turns the ranking off (every candidate is timed). A
candidate whose plan function refuses it (``gemm_plan.PlanError``, raised
before any launch) is skipped; any other error propagates, since a fault on
the card is sticky for the process.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Callable, Iterable

import torch

from repro_torch import faults
from repro_torch.health import HEALTH
from repro_torch.kernels import build, gemm_plan, timing
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

DEFAULT_CACHE = ".cache/autotune_cuda.json"
ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"

# bump when the cache entry layout changes incompatibly; readers quarantine
# files stamped with a DIFFERENT version (missing field = legacy schema 1)
SCHEMA_VERSION = 1
SCHEMA_KEY = "__schema__"
CARD_KEY = "__card__"

# candidate axes: split counts of a product (capped at the reduction's
# chunks // MIN_SPLIT_CHUNKS, plus the rule's own), split lengths of decode
# attention (capped at min(S, MAX_SPLIT_ROWS), plus the rule's own)
SPLIT_CANDIDATES = (1, 2, 3, 4, 6, 8, 12, 16)
DW_STAGE_CANDIDATES = (2, 3, 4)
ATTN_ROWS_CANDIDATES = (64, 128, 256, 512)
# calls a timed batch (``_time_fn``)
TIME_INNER = 10


def cache_path() -> Path:
    return Path(os.environ.get(ENV_CACHE, DEFAULT_CACHE))


_cache: dict[str, dict[str, Any]] | None = None
_cache_file: Path | None = None  # the path the cache was read from


def _quarantine(p: Path, reason: str, detail: str = "") -> None:
    """Move an unusable cache file aside (never delete: the operator may
    want the bytes) and record the event."""
    try:
        quarantined = p.with_name(p.name + ".corrupt")
        p.replace(quarantined)
        detail = detail or str(quarantined)
    except OSError:
        pass  # racing process already moved/removed it
    HEALTH.record("autotune", reason, "quarantine", detail=detail)


def _load() -> dict[str, dict[str, Any]]:
    """The cache of ``cache_path()`` as it was at the first load after an
    ``invalidate()``, kept in memory with its path: a launch's lookup is
    a dict lookup, with no read of the environment or the file system."""
    global _cache, _cache_file
    if _cache is None:
        _cache_file = p = cache_path()
        _cache = {}
        try:
            text = p.read_text()
        except OSError:
            return _cache  # no cache yet — nothing to validate
        try:
            if faults.take("autotune_corrupt"):
                raise ValueError("injected fault 'autotune_corrupt'")
            loaded = json.loads(text)
            if not isinstance(loaded, dict):
                raise ValueError(f"cache root is {type(loaded).__name__}")
        except ValueError as e:
            _quarantine(p, "cache_corrupt", detail=repr(e)[:200])
            return _cache
        schema = loaded.pop(SCHEMA_KEY, SCHEMA_VERSION)
        if schema != SCHEMA_VERSION:
            _quarantine(p, "cache_schema_mismatch",
                        detail=f"file schema {schema} != {SCHEMA_VERSION}")
            return _cache
        loaded.pop(CARD_KEY, None)
        _cache = loaded
    return _cache


def _card() -> dict[str, Any]:
    """The card the entries were timed on, and its SM count."""
    if not torch.cuda.is_available():
        return {"name": "cpu", "sms": None}
    dev = torch.device("cuda", torch.cuda.current_device())
    return {"name": torch.cuda.get_device_name(dev),
            "sms": build.sm_count(dev)}


def _flush() -> None:
    p = _cache_file
    p.parent.mkdir(parents=True, exist_ok=True)
    # per-process temp name: concurrent tuners each write their own temp and
    # the atomic rename is last-writer-wins
    tmp = p.parent / f".{p.name}.{os.getpid()}.tmp"
    tmp.write_text(json.dumps(
        {SCHEMA_KEY: SCHEMA_VERSION, CARD_KEY: _card(), **_cache},
        indent=1, sort_keys=True))
    tmp.replace(p)


def invalidate() -> None:
    """Drop the in-memory cache: the next lookup reads
    ``$REPRO_TORCH_AUTOTUNE_CACHE`` again, and the file it names."""
    global _cache
    _cache = None


def conv1d_key(B, L, Cin, Cout, K, stride, dtype, grad: bool = False) -> str:
    """conv1d shape key (``dtype`` is the precision name for the quantized
    kernel, e.g. "w8a8"); ``grad=True`` keys the backward entry."""
    base = f"conv1d|B{B}|L{L}|Cin{Cin}|Cout{Cout}|K{K}|s{stride}|{dtype}"
    return base + "|grad" if grad else base


def conv2d_key(B, H, W, Cin, Cout, kh, kw, sh, sw, dtype,
               grad: bool = False) -> str:
    """conv2d shape key; ``grad=True`` keys the backward entry."""
    base = (f"conv2d|B{B}|H{H}|W{W}|Cin{Cin}|Cout{Cout}"
            f"|K{kh}x{kw}|s{sh}x{sw}|{dtype}")
    return base + "|grad" if grad else base


def conv1d_dw_key(B, L, C, K, stride, dtype) -> str:
    """Depthwise conv1d shape key (the mamba conv path; ``dtype`` is the
    precision name for the quantized kernel, e.g. "w8a8")."""
    return f"conv1ddw|B{B}|L{L}|C{C}|K{K}|s{stride}|{dtype}"


def attn_dec_key(B, S, KV, G, D, kind) -> str:
    """Fused decode-attention shape key (``ops.attention_decode``). ``kind``
    is "int8" for the quantized cache, else the float cache dtype name."""
    return f"attn_dec|B{B}|S{S}|KV{KV}|G{G}|D{D}|{kind}"


def pool1d_key(B, L, C, window, op, dtype) -> str:
    """Sliding-pool shape key (``ops.pool1d``); the tuned entry selects the
    max-pool evaluation (``scan`` or ``shift``)."""
    return f"pool1d|B{B}|L{L}|C{C}|w{window}|{op}|{dtype}"


def lookup(key: str) -> dict[str, Any] | None:
    """Tuned plan for a shape key, or None if never tuned."""
    return _load().get(key)


def record(key: str, config: dict[str, Any]) -> None:
    _load()[key] = config
    _flush()


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _time_fn(fn: Callable[[], Any], warmup: int = 1, iters: int = 3) -> float:
    """Median card seconds a call: ``iters`` batches of ``TIME_INNER``
    calls, each timed by CUDA events with the card's queue filled first
    (``timing.card_ms``)."""
    return timing.card_ms(fn, batches=iters, inner=TIME_INNER,
                          warmup=warmup) / 1e3


@dataclasses.dataclass
class Result:
    key: str
    best: dict[str, Any]
    default_us: float
    best_us: float
    pruned: int = 0  # candidates skipped on a contract verdict, untimed
    timed: int = 0  # configs actually measured (incl. the default)
    cost_skipped: int = 0  # ranked early-exit leftovers, untimed
    ranked: bool = False  # candidates were ordered by the cost model

    @property
    def speedup(self) -> float:
        return self.default_us / self.best_us if self.best_us else 1.0


#: a ranked search stops after this many candidates in a row fail to
#: improve on the best time (the rest are predicted slower still)
COST_PATIENCE = 3


def _contract_checker(family: str, shape: dict[str, Any]):
    """The launch contract's verdict for a candidate
    (``repro_torch.analysis.contracts``): a plan that provably breaks a
    limit of the card (shared memory, occupancy, the grid) is pruned
    before it is timed. The default is never asked."""
    from repro_torch.analysis import contracts

    def check(cand: dict[str, Any]):
        return contracts.check_autotune_candidate(family, shape, cand)

    return check


def _cost_model(family: str, shape: dict[str, Any]):
    """The H100 roofline's prediction for a candidate
    (``repro_torch.analysis.costmodel``): candidates are timed
    best-predicted-first so that the search can stop once times stop
    improving. None where ``REPRO_TORCH_AUTOTUNE_COST=0`` (the kill
    switch: every candidate is timed); a candidate the model cannot
    predict gets None, and then nothing is ranked."""
    if os.environ.get("REPRO_TORCH_AUTOTUNE_COST", "1") == "0":
        return None
    from repro_torch.analysis import costmodel

    return costmodel.candidate_cost(family, shape)


def _ranked(
    cands: list[dict[str, Any]],
    cost: Callable[[dict[str, Any]], float | None] | None,
) -> tuple[list[dict[str, Any]], bool]:
    """Candidates ordered by predicted time (stable); ranked only where
    every candidate has a finite prediction, since an early stop compares
    the times against the predicted order."""
    if cost is None or not cands:
        return cands, False
    preds = [cost(c) for c in cands]
    if any(p is None or not math.isfinite(p) for p in preds):
        return cands, False
    order = sorted(range(len(cands)), key=lambda i: preds[i])
    return [cands[i] for i in order], True


def _search(
    key: str,
    run: Callable[[dict[str, Any]], Any],
    candidates: Iterable[dict[str, Any]],
    default: dict[str, Any],
    contract: Callable[[dict[str, Any]], Any] | None = None,
    cost: Callable[[dict[str, Any]], float | None] | None = None,
) -> Result:
    """Time the default, then the other candidates (best-predicted-first
    where ``cost`` ranks them all); persist the winner with its ``us`` and
    the default's ``default_us``; return the result.

    A candidate the ``contract`` gives a verdict on is pruned untimed
    (counted in ``pruned``, one stderr line each); the default is never
    asked. Ranked, the search stops after ``COST_PATIENCE`` timed
    candidates in a row fail to improve on the best time (the rest are
    ``cost_skipped``). A candidate whose plan is refused
    (``gemm_plan.PlanError``) is skipped untimed.

    Observability, as the reference's: the search runs under an
    ``autotune.search`` span with one ``autotune.candidate`` span per
    timed plan, and the ``autotune.searches`` / ``candidates`` /
    ``pruned`` / ``cost_skipped`` counters land in the metrics registry
    per key."""
    reg = obs_metrics.REGISTRY
    reg.counter("autotune.searches").inc(1.0, key=key)
    cands = [c for c in candidates if c != default]
    cands, ranked = _ranked(cands, cost)
    patience = COST_PATIENCE if ranked else 0
    with obs_trace.span("autotune.search", key=key):
        with obs_trace.span("autotune.candidate", key=key, cand="default"):
            default_t = _time_fn(lambda: run(default))
        reg.counter("autotune.candidates").inc(1.0, key=key)
        best_cfg, best_t = dict(default), default_t
        pruned = timed = cost_skipped = since_improve = 0
        for i, cand in enumerate(cands):
            if contract is not None:
                verdict = contract(cand)
                if verdict is not None:
                    pruned += 1
                    reg.counter("autotune.pruned").inc(1.0, key=key)
                    print(f"[autotune] pruned {key} cand={cand}: "
                          f"{verdict.kind} ({verdict.detail})",
                          file=sys.stderr)
                    continue
            try:
                with obs_trace.span("autotune.candidate", key=key,
                                    cand=str(cand)):
                    t = _time_fn(lambda: run(cand))
            except gemm_plan.PlanError:  # refused before any launch: skip
                continue
            timed += 1
            reg.counter("autotune.candidates").inc(1.0, key=key)
            if t < best_t:
                best_cfg, best_t = dict(cand), t
                since_improve = 0
            else:
                since_improve += 1
            if patience and since_improve >= patience:
                cost_skipped = len(cands) - i - 1
                if cost_skipped:
                    reg.counter("autotune.cost_skipped").inc(
                        float(cost_skipped), key=key)
                break
    best_cfg["us"] = round(best_t * 1e6, 2)
    best_cfg["default_us"] = round(default_t * 1e6, 2)
    record(key, best_cfg)
    return Result(key, best_cfg, default_t * 1e6, best_t * 1e6, pruned,
                  timed=timed + 1, cost_skipped=cost_skipped, ranked=ranked)


def _hooks(family: str, shape: dict[str, Any]) -> dict[str, Any]:
    """``_search``'s contract and cost hooks for a family at a shape."""
    return dict(contract=_contract_checker(family, shape),
                cost=_cost_model(family, shape))


# ---------------------------------------------------------------------------
# candidates: (the rule's plan, the forced plans to time), on the CPU too
# ---------------------------------------------------------------------------

def gemm_candidates(M: int, N: int, K: int, dtype: torch.dtype,
                    sms: int = build.DEFAULT_SMS):
    """The rule's ``{"tile", "splits"}`` for C (M, N) = A (M, K) @ B (K,
    N) with A of ``dtype``, and the forced plans: each tile the type takes
    (``gemm_plan.DTYPE_TILES``) × each split count of ``SPLIT_CANDIDATES``
    up to its chunks // ``MIN_SPLIT_CHUNKS``, and the rule's count, each
    as the plan rounds it, without repeats."""
    rule = gemm_plan.gemm_plan(M, N, K, dtype, sms)
    default = {"tile": rule.tile.name, "splits": rule.splits}
    cands = []
    for name in gemm_plan.DTYPE_TILES[dtype]:
        chunks = -(-K // gemm_plan.TILES[name].bk)
        top = max(1, chunks // gemm_plan.MIN_SPLIT_CHUNKS)
        counts = {s for s in SPLIT_CANDIDATES if s <= top} | {rule.splits}
        for s in sorted(counts):
            p = gemm_plan.gemm_plan(M, N, K, dtype, sms, tile=name, splits=s)
            c = {"tile": name, "splits": p.splits}
            if c not in cands:
                cands.append(c)
    return default, cands


def depthwise_candidates(B: int, Lout: int, C: int, elem_bytes: int, K: int,
                         stride: int, sms: int = build.DEFAULT_SMS):
    """The rule's ``{"rows", "stages"}`` for rows 3 and 15, and every
    item length of ``DW_ROWS`` × ring depth 2–4 whose ring fits a block."""
    rule = gemm_plan.depthwise_plan(B, Lout, C, elem_bytes, K, stride, sms)
    cands = []
    for r in gemm_plan.DW_ROWS:
        for st in DW_STAGE_CANDIDATES:
            try:
                gemm_plan.depthwise_plan(B, Lout, C, elem_bytes, K, stride,
                                         sms, rows=r, stages=st)
            except gemm_plan.PlanError:
                continue
            cands.append({"rows": r, "stages": st})
    return {"rows": rule.rows, "stages": rule.stages}, cands


def depthwise_dw_candidates(B: int, Lout: int, C: int, elem_bytes: int,
                            K: int, stride: int,
                            sms: int = build.DEFAULT_SMS):
    """Row 11's rule as ``{"bwd_rows", "bwd_stages", "bwd_splits"}``, and
    every item length of ``DW_ROWS`` × ring depth 2–4 that fits a block ×
    each split of ``SPLIT_CANDIDATES`` up to a slab's items and the
    rule's split."""
    rule = gemm_plan.depthwise_dw_plan(B, Lout, C, elem_bytes, K, stride,
                                       sms)
    cands = []
    for r in gemm_plan.DW_ROWS:
        for st in DW_STAGE_CANDIDATES:
            try:
                p = gemm_plan.depthwise_dw_plan(B, Lout, C, elem_bytes, K,
                                                stride, sms, rows=r, stages=st)
            except gemm_plan.PlanError:
                continue
            n = p.items // p.slabs
            for s in sorted({s for s in SPLIT_CANDIDATES if s <= n}
                            | {min(rule.splits, n)}):
                cands.append({"bwd_rows": r, "bwd_stages": st,
                              "bwd_splits": s})
    return ({"bwd_rows": rule.rows, "bwd_stages": rule.stages,
             "bwd_splits": rule.splits}, cands)


def attention_candidates(bkv: int, S: int, sms: int = build.DEFAULT_SMS):
    """The rule's ``{"split_rows"}`` for ``bkv`` (slot, head) pairs over S
    cache rows, and the split lengths of ``ATTN_ROWS_CANDIDATES`` and S up
    to min(S, ``MAX_SPLIT_ROWS``), and the rule's."""
    from repro_torch.kernels import attention_decode as attn_dec

    _, rule = attn_dec.decode_splits(bkv, S, sms)
    top = min(S, attn_dec.MAX_SPLIT_ROWS)
    rows = {r for r in (*ATTN_ROWS_CANDIDATES, S) if 1 <= r <= top} | {rule}
    return {"split_rows": rule}, [{"split_rows": r} for r in sorted(rows)]


# ---------------------------------------------------------------------------
# the searches
# ---------------------------------------------------------------------------

def _require_card(t: torch.Tensor) -> int:
    """The SM count of the card ``t`` lies on; raises for a CPU tensor
    (its plain version takes no plan: there is nothing to time)."""
    if t.device.type != "cuda":
        raise ValueError(f"tuning times the CUDA kernels; got a tensor on "
                         f"{t.device} (its plain version takes no plan)")
    return build.sm_count(t.device)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _float_name(x: torch.Tensor) -> str:
    """The float type a conv computes in: x's, or float32 for int8 x."""
    return "float32" if x.dtype == torch.int8 else _dtype_name(x)


def _quantized(x, w, precision, depthwise=False):
    """Operands quantized once ahead of the timed calls (the reference's
    autotune_conv1d does the same): (x, w_q, w_scale, x_scale, out_dtype).
    The quant searches time the int8 wrapper on them, not ``ops``: ops
    reads the scales on the host at every call (its scale guard), which
    would put a synchronise into the quant timings and not the float
    ones."""
    from repro_torch.kernels import ops
    from repro_torch.quant import qconv
    from repro_torch.quant.apply import quantize_depthwise_weight

    return ops._quant_operands(
        x, w, None, None, precision,
        quantize_depthwise_weight if depthwise else qconv.quantize_weight)


def _dw_leaves(x, w):
    """(x, w, the leaves to differentiate): w always, x where the caller's
    x requires a gradient (an image does not: the patch embedding's
    backward runs no dx conv)."""
    xg = x.detach().requires_grad_(x.requires_grad)
    wg = w.detach().requires_grad_()
    return xg, wg, [t for t in (xg, wg) if t.requires_grad]


def autotune_conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    precision: str = "fp",
    bias: torch.Tensor | None = None,
    activation: str = "none",
) -> Result:
    """Search the tile and split-K of the sliding conv1d's product (row 1;
    row 13 for ``precision`` "w8a8"/"w8a16", under its precision-named
    key) for a VALID conv of x (B, L, Cin) by w (K, Cin, Cout) on the
    card; persist the winner. For a float x in a quant precision the
    entry also holds ``dispatch_us``, the winner timed through a
    float-input ``ops.conv1d``: the time the quant guard
    (``ops._quant_fallback_reason``) holds against the float entry's."""
    from repro_torch.kernels import ops, sliding_conv_quant

    sms = _require_card(x)
    B, L, Cin = x.shape
    K, _, Cout = w.shape
    key = conv1d_key(B, L, Cin, Cout, K, stride,
                     precision if precision != "fp" else _dtype_name(x))
    lout = (L - K) // stride + 1
    if precision == "fp":
        adt = x.dtype

        def run(cfg):
            with torch.no_grad():
                return ops.conv1d(x, w, stride=stride, bias=bias,
                                  activation=activation, plan=cfg)
    else:
        xq, wq, ws, xs, odt = _quantized(x, w, precision)
        adt = xq.dtype

        def run(cfg):
            return sliding_conv_quant.conv1d_quant(
                xq, wq, ws, bias, x_scale=xs, mode=precision, stride=stride,
                activation=activation, out_dtype=odt, plan=cfg)

    default, cands = gemm_candidates(B * lout, Cout, K * Cin, adt, sms)
    res = _search(key, run, cands, default, **_hooks("conv1d", dict(
        B=B, L=L, Cin=Cin, Cout=Cout, K=K, stride=stride,
        precision=precision, dtype=_float_name(x), sms=sms)))
    if precision != "fp" and x.dtype != torch.int8:
        # the quant guard's figure: the winner through a float-input ops
        # call, which also quantizes x and screens its scales on the host
        # (the weights quantized once, as a model holds them)
        plan = {f: res.best[f] for f in ("tile", "splits")}
        with torch.no_grad():
            t = _time_fn(lambda: ops.conv1d(
                x, wq, stride=stride, bias=bias, activation=activation,
                precision=precision, w_scale=ws, plan=plan))
        res.best["dispatch_us"] = round(t * 1e6, 2)
        record(key, res.best)
    return res


def autotune_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: tuple[int, int] = (1, 1),
    precision: str = "fp",
    bias: torch.Tensor | None = None,
    activation: str = "none",
) -> Result:
    """Search the tile and split-K of the sliding conv2d's product (row 4;
    row 14 for ``precision`` "w8a8"/"w8a16") for a VALID conv of x (B, H,
    W, Cin) by w (kh, kw, Cin, Cout) on the card; persist the winner."""
    from repro_torch.kernels import ops, sliding_conv_quant

    sms = _require_card(x)
    stride = tuple(stride)
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    key = conv2d_key(B, H, W, Cin, Cout, kh, kw, *stride,
                     precision if precision != "fp" else _dtype_name(x))
    oh = (H - kh) // stride[0] + 1
    ow = (W - kw) // stride[1] + 1
    if precision == "fp":
        adt = x.dtype

        def run(cfg):
            with torch.no_grad():
                return ops.conv2d(x, w, stride=stride, backend="sliding",
                                  bias=bias, activation=activation, plan=cfg)
    else:
        xq, wq, ws, xs, odt = _quantized(x, w, precision)
        adt = xq.dtype

        def run(cfg):
            return sliding_conv_quant.conv2d_quant(
                xq, wq, ws, bias, x_scale=xs, mode=precision, stride=stride,
                activation=activation, out_dtype=odt, plan=cfg)

    default, cands = gemm_candidates(B * oh * ow, Cout, kh * kw * Cin, adt,
                                     sms)
    return _search(key, run, cands, default, **_hooks("conv2d", dict(
        B=B, H=H, W=W, Cin=Cin, Cout=Cout, kh=kh, kw=kw, stride=stride,
        precision=precision, dtype=_float_name(x), sms=sms)))


def autotune_conv1d_depthwise(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    precision: str = "w8a8",
    bias: torch.Tensor | None = None,
    activation: str = "none",
) -> Result:
    """Search the depthwise conv's item length and ring depth (row 3; row
    15 for ``precision`` "w8a8"/"w8a16") for a VALID depthwise conv of x
    (B, L, C) by w (K, C) on the card; persist the winner under
    ``conv1d_dw_key``. In floating point, where x needs a gradient, a
    second search under the same key times forward and backward through
    ``Conv1dDepthwise`` with the forward's winner and row 11's plans
    (``bwd_rows``, ``bwd_stages``, ``bwd_splits``) against the rule
    everywhere, and persists the whole entry."""
    from repro_torch.kernels import ops, sliding_conv_quant

    sms = _require_card(x)
    B, L, C = x.shape
    K = w.shape[0]
    key = conv1d_dw_key(B, L, C, K, stride,
                        precision if precision != "fp" else _dtype_name(x))
    lout = (L - K) // stride + 1
    if precision == "fp":
        def run(cfg):
            with torch.no_grad():
                return ops.conv1d_depthwise(
                    x, w, stride=stride, padding="VALID", bias=bias,
                    activation=activation, plan=cfg)
        elem = x.element_size()
    else:
        xq, wq, ws, xs, odt = _quantized(x, w, precision, depthwise=True)
        elem = xq.element_size()

        def run(cfg):
            return sliding_conv_quant.conv1d_depthwise_quant(
                xq, wq, ws, bias, x_scale=xs, mode=precision, stride=stride,
                activation=activation, out_dtype=odt, plan=cfg)

    default, cands = depthwise_candidates(B, lout, C, elem, K, stride, sms)
    shape = dict(B=B, L=L, C=C, K=K, stride=stride, dtype=_float_name(x),
                 sms=sms)
    res = _search(key, run, cands, default, **_hooks(
        "conv1d_depthwise", dict(shape, precision=precision)))
    if precision != "fp" or not x.requires_grad:
        return res
    fwd = {k: res.best[k] for k in ("rows", "stages")}
    bdefault, bcands = depthwise_dw_candidates(B, lout, C, elem, K, stride,
                                               sms)
    xg, wg, bg = (None if t is None else t.detach().requires_grad_()
                  for t in (x, w, bias))
    leaves = [t for t in (xg, wg, bg) if t is not None]

    def run_grad(cfg):
        y = ops.conv1d_depthwise(xg, wg, stride=stride, padding="VALID",
                                 bias=bg, activation=activation, plan=cfg)
        return torch.autograd.grad(y.sum(), leaves)

    return _search(key, run_grad, [{**fwd, **b} for b in bcands],
                   {**default, **bdefault},
                   **_hooks("conv1d_depthwise_bwd_dw", shape))


def autotune_attention_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    lengths: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> Result:
    """Search the decode-attention kernel's split length (rows 2 and 2b)
    for a cache shape on the card; persist the winner under the
    ``attn_dec|…`` key consulted by ``ops.attention_decode``. q: (B, H, D);
    k/v: (B, S, KV, D), int8 with scale rows or float; lengths default to
    S."""
    from repro_torch.kernels import ops

    sms = _require_card(q)
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    kind = "int8" if k.dtype == torch.int8 else _dtype_name(k)
    key = attn_dec_key(B, S, KV, H // KV, D, kind)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=q.device)

    def run(cfg):
        return ops.attention_decode(q, k, v, lengths=lengths,
                                    k_scale=k_scale, v_scale=v_scale,
                                    plan=cfg)

    default, cands = attention_candidates(B * KV, S, sms)
    return _search(key, run, cands, default, **_hooks(
        "attention_decode", dict(B=B, S=S, KV=KV, G=H // KV, D=D, kind=kind,
                                 sms=sms)))


def autotune_pool1d(x: torch.Tensor, *, window: int,
                    op: str = "max") -> Result:
    """Time the pool kernel's evaluations for a shape (row 8) and persist
    the winner's ``method``: for max the two-phase scan and the
    shift-and-max loop, for sum and avg the scan alone. The default is
    ``scan``, as the reference's."""
    from repro_torch.kernels import ops

    sms = _require_card(x)
    B, L, C = x.shape
    key = pool1d_key(B, L, C, window, op, _dtype_name(x))

    def run(cfg):
        with torch.no_grad():
            return ops.pool1d(x, window=window, op=op, method=cfg["method"])

    methods = ["scan", "shift"] if op == "max" else ["scan"]
    return _search(key, run, [{"method": m} for m in methods],
                   {"method": methods[0]}, **_hooks("pool1d", dict(
                       B=B, L=L, C=C, window=window, op=op,
                       dtype=_dtype_name(x), sms=sms)))


# ---------------------------------------------------------------------------
# backward (training) tuning — forward and backward timed together, the
# winner recorded under the |grad key that the autograd Functions consult
# ---------------------------------------------------------------------------

def autotune_conv1d_grad(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
) -> Result:
    """Search the tile and split of the conv1d weight gradient's product
    (row 10) for a conv1d shape on the card, timing one forward and
    backward through ``Conv1dSliding`` (w's gradient, and x's through the
    dx conv under its own key where x requires one); persist the winner
    under the ``grad=True`` key."""
    from repro_torch.kernels import ops

    sms = _require_card(x)
    B, L, Cin = x.shape
    K, _, Cout = w.shape
    key = conv1d_key(B, L, Cin, Cout, K, stride, _dtype_name(x), grad=True)
    lout = (L - K) // stride + 1
    xg, wg, leaves = _dw_leaves(x, w)

    def run(cfg):
        y = ops.conv1d(xg, wg, stride=stride, bwd_plan=cfg)
        return torch.autograd.grad(y.sum(), leaves)

    default, cands = gemm_candidates(K * Cin, Cout, B * lout, x.dtype, sms)
    return _search(key, run, cands, default, **_hooks("conv1d_bwd_dw", dict(
        B=B, L=L, Cin=Cin, Cout=Cout, K=K, stride=stride,
        dtype=_dtype_name(x), has_bias=False, sms=sms)))


def autotune_conv2d_grad(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: tuple[int, int] = (1, 1),
) -> Result:
    """Search the tile and split of the conv2d weight gradient's product
    (row 12) for a conv2d shape on the card, timing one forward and
    backward through ``Conv2dSliding`` (w's gradient, and x's where x
    requires one); persist the winner under the ``grad=True`` key."""
    from repro_torch.kernels import ops

    sms = _require_card(x)
    stride = tuple(stride)
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    key = conv2d_key(B, H, W, Cin, Cout, kh, kw, *stride, _dtype_name(x),
                     grad=True)
    oh = (H - kh) // stride[0] + 1
    ow = (W - kw) // stride[1] + 1
    xg, wg, leaves = _dw_leaves(x, w)

    def run(cfg):
        y = ops.conv2d(xg, wg, stride=stride, backend="sliding",
                       bwd_plan=cfg)
        return torch.autograd.grad(y.sum(), leaves)

    default, cands = gemm_candidates(kh * kw * Cin, Cout, B * oh * ow,
                                     x.dtype, sms)
    return _search(key, run, cands, default, **_hooks("conv2d_bwd_dw", dict(
        B=B, H=H, W=W, Cin=Cin, Cout=Cout, kh=kh, kw=kw, stride=stride,
        dtype=_dtype_name(x), has_bias=False, sms=sms)))
