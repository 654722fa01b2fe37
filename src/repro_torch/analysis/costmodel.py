"""A roofline cost model of the port's kernels on the H100.

For every :class:`~repro_torch.analysis.contracts.KernelInstance` the
contract builders emit, the predicted time is

    t = max(ops / peak[type], hbm_bytes / bw, smem_traffic / smem_bw)

quantised by waves: the blocks of a launch are spread over the card's SMs,
the SM with the most blocks (⌈blocks / sms⌉, as ``gemm_plan``'s
``_balanced_splits`` counts them) sets the time. An SM reaches its share
of the arithmetic peak only with ``SATURATING_WARPS`` warps resident, and
its share of the bandwidth only with its share × ``LATENCY_S`` bytes in
flight (its resident blocks' rings), so a plan of fewer resident blocks,
or a grid that leaves SMs idle, is slower. A fourth ceiling is latency:
each round of resident blocks takes the busiest block's unhidden round
trips to device memory (``serial_steps``) × ``LATENCY_S``. A split
reduction adds its second pass: the partials written, and read back at the
share of the card its blocks cover (decode attention merges on one block
a (slot, head)). The terms:

  * **ops**: the busiest block's operations as launched (a tile's padding
    included), over the peak of its operand type: float32 on the CUDA
    cores, bfloat16 and int8 on the tensor cores.
  * **hbm_bytes**: each block's reads of its operands (so halo re-reads
    and the per-tile re-reads of a weight scale as they do on the card),
    the output written once, and for splits > 1 the partials written and
    read back by the second pass. The model ignores the 50 MB L2, its
    known blind spot: a re-read that hits L2 is counted as a read from
    device memory.
  * **smem_traffic**: the bytes the busiest block moves through shared
    memory (its stages written, then read by its warps).

Peaks come from a peaks file that :func:`probe_peaks` writes on the card,
else from the H100 SXM data sheet's figures below. Within one shape key
the ranking that the tuning searches use (:func:`candidate_cost`) depends
little on the absolute peaks.

``SATURATING_WARPS``, ``LATENCY_S`` and the second pass's share of the card
were set on the card's measured times of the tuning searches' plans, not
derived: the ρ that :func:`validate` gates is measured on shapes of the
same searches.

:func:`validate` holds the predictions to the tuning cache's measured
winners (``autotune.cache_path()``) per family: MAPE (reported) and
Spearman ρ (gated at ``SPEARMAN_GATE`` where a family has at least
``GATE_MIN_ROWS`` tuned rows: ranked search relies on the order).
"""
from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Any, Callable, Iterable

import torch

from repro_torch.analysis.contracts import (
    FAMILIES,
    KernelInstance,
    Violation,
    default_space,
)
from repro_torch.kernels import build

# H100 SXM (NVIDIA data sheet, dense, at 700 W): device memory rate and the
# arithmetic rate by operand type. float32 runs on the CUDA cores: the port
# keeps TF32 off.
H100_HBM_BYTES_S = 3.35e12
H100_PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
# shared memory: 128 bytes a clock an SM at the 1.98 GHz boost clock, on
# 132 SMs (derived from the SM's design, not a data-sheet figure)
H100_SMEM_BYTES_S = 132 * 128 * 1.98e9
# warps an SM needs resident to issue at its share of a peak: one for each
# of its four schedulers (the kernels' warps carry many independent
# operations each)
SATURATING_WARPS = 4
# a round trip to device memory under load; an SM keeps its share of the
# bandwidth busy with its share × this many bytes in flight (Little's law)
LATENCY_S = 0.8e-6

DEFAULT_PEAKS = ".cache/peaks_cuda.json"
ENV_PEAKS = "REPRO_TORCH_PEAKS"

# the probes of probe_peaks: square products and a device-to-device copy
PROBE_N = 8192
PROBE_COPY_BYTES = 1 << 30

#: Spearman ρ below this on a tuned family is a ``cost_rank`` violation
SPEARMAN_GATE = 0.7
#: rows a family needs before the gate applies
GATE_MIN_ROWS = 3


class Peaks:
    """Rates in base units (operations/s by type, bytes/s) and the SM count
    the waves are counted over."""

    def __init__(self, ops: dict[str, float], hbm_bw: float, smem_bw: float,
                 source: str = "prior", sms: int = build.DEFAULT_SMS):
        self.ops, self.hbm_bw, self.smem_bw = dict(ops), hbm_bw, smem_bw
        self.source, self.sms = source, sms

    def as_stats(self) -> dict[str, Any]:
        return {
            "tflops": {k: round(v / 1e12, 1) for k, v in self.ops.items()},
            "hbm_gbps": round(self.hbm_bw / 1e9, 1),
            "smem_gbps": round(self.smem_bw / 1e9, 1),
            "source": self.source,
        }


def _load(path) -> dict[str, Any]:
    if isinstance(path, dict):
        return path
    p = Path(path if path is not None
             else os.environ.get(ENV_PEAKS, DEFAULT_PEAKS))
    try:
        got = json.loads(p.read_text())
    except (OSError, ValueError):
        return {}
    return got if isinstance(got, dict) else {}


def peaks(path: str | Path | dict | None = None) -> Peaks:
    """The peaks: a peaks file's (``path``, else ``$REPRO_TORCH_PEAKS``,
    else ``.cache/peaks_cuda.json``; absent: none) over the data sheet's. A
    probed int8 rate is not measured: int8 takes the bfloat16 probe's share
    of its data-sheet rate (the same tensor cores)."""
    probed = _load(path)
    ops, src = dict(H100_PEAK_OPS), []
    if "bfloat16_tflops" in probed and "float32_tflops" in probed:
        share = probed["bfloat16_tflops"] * 1e12 / H100_PEAK_OPS["bfloat16"]
        ops = {"float32": probed["float32_tflops"] * 1e12,
               "bfloat16": probed["bfloat16_tflops"] * 1e12,
               "int8": H100_PEAK_OPS["int8"] * share}
        src.append("probe")
    else:
        src.append("prior")
    if "hbm_gbps" in probed:
        hbm = probed["hbm_gbps"] * 1e9
        src.append("probe")
    else:
        hbm = H100_HBM_BYTES_S
        src.append("prior")
    return Peaks(ops, hbm, H100_SMEM_BYTES_S, "+".join(src),
                 int(probed.get("sms", build.DEFAULT_SMS)))


def probe_peaks(device: torch.device | int | None = None,
                path: str | Path | None = None) -> dict[str, Any]:
    """Measure the card's peaks and write them to ``path`` (default
    ``$REPRO_TORCH_PEAKS`` or ``.cache/peaks_cuda.json``): a bfloat16 and
    a float32 ``torch.matmul`` of ``PROBE_N``³ (TF32 off) and a
    device-to-device copy of ``PROBE_COPY_BYTES``, each timed with
    ``kernels/timing.card_ms``, beside the card's name and power limit.
    Returns what it wrote."""
    import subprocess

    from repro_torch.kernels.timing import card_ms

    dev = torch.device("cuda", torch.cuda.current_device()
                       if device is None else
                       device if isinstance(device, int) else device.index)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out: dict[str, Any] = {"card": torch.cuda.get_device_name(dev),
                           "sms": build.sm_count(dev)}
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={dev.index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60)
        out["nvidia_smi"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["nvidia_smi"] = None
    n = PROBE_N
    g = torch.Generator(device=dev).manual_seed(0)
    ms = {}
    for name in ("bfloat16", "float32"):
        a = torch.randn((n, n), generator=g, device=dev).to(getattr(torch,
                                                                     name))
        b = torch.randn((n, n), generator=g, device=dev).to(a.dtype)
        ms[name] = card_ms(lambda a=a, b=b: torch.matmul(a, b), batches=5,
                           inner=3, warmup=2)
        out[f"{name}_tflops"] = 2 * n ** 3 / (ms[name] * 1e-3) / 1e12
        del a, b
    torch.backends.cuda.matmul.allow_tf32 = prev
    src = torch.empty(PROBE_COPY_BYTES // 4, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    ms["copy"] = card_ms(lambda: dst.copy_(src), batches=5, inner=3,
                         warmup=2)
    out["hbm_gbps"] = 2 * PROBE_COPY_BYTES / (ms["copy"] * 1e-3) / 1e9
    out["ms"] = ms
    del src, dst
    p = Path(path if path is not None
             else os.environ.get(ENV_PEAKS, DEFAULT_PEAKS))
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(out, indent=1))
    return out


# ---------------------------------------------------------------------------
# work, from the shape alone
# ---------------------------------------------------------------------------

def _out_len(L, K, stride):
    return (L - K) // stride + 1


def instance_flops(family: str, shape: dict[str, Any], **extra) -> float:
    """Arithmetic work of one call, from the shape dict the contract
    builder takes: the reference's ``instance_flops`` for the families the
    two packages share, whatever implements them. ``extra`` carries the
    pool's ``method`` (the scan is O(n) whatever the window, the shift
    O(n·w))."""
    s = shape
    if family in ("conv1d", "conv1d_bwd_dw", "conv1d_im2col"):
        ol = _out_len(s["L"], s["K"], s.get("stride", 1))
        return 2.0 * s["B"] * ol * s["K"] * s["Cin"] * s["Cout"]
    if family in ("conv2d", "conv2d_bwd_dw", "conv2d_im2col"):
        st = s.get("stride", (1, 1))
        oh = _out_len(s["H"], s["kh"], st[0])
        ow = _out_len(s["W"], s["kw"], st[1])
        return 2.0 * s["B"] * oh * ow * s["kh"] * s["kw"] * s["Cin"] * s["Cout"]
    if family == "matmul":
        return 2.0 * s["M"] * s["N"] * s["K"]
    if family in ("conv1d_depthwise", "conv1d_depthwise_bwd_dw"):
        ol = _out_len(s["L"], s["K"], s.get("stride", 1))
        return 2.0 * s["B"] * ol * s["K"] * s["C"]
    if family in ("pool1d", "max_pool_bwd"):
        ol = _out_len(s["L"], s["window"], 1)
        if extra.get("method") == "scan":
            return 4.0 * s["B"] * s["L"] * s["C"]  # two prefix phases
        return float(s["B"] * ol * s["C"] * s["window"])
    if family == "attention_decode":
        h = s["KV"] * s["G"]
        # qk and pv dots (2 flops each) + online-softmax bookkeeping
        return 4.0 * s["B"] * h * s["S"] * s["D"] + 8.0 * s["B"] * h * s["S"]
    if family == "ssm_scan":
        return 4.0 * s["B"] * s["L"] * s["D"] * s["N"]
    raise KeyError(f"no flops model for family {family!r}")


# ---------------------------------------------------------------------------
# traffic and time, from the instance
# ---------------------------------------------------------------------------

def _partial_bytes(inst: KernelInstance) -> int:
    """The splits' partials (four bytes each), written by the first pass
    and read back by the second."""
    if inst.splits <= 1:
        return 0
    return 2 * inst.splits * inst.partial * 4


def _second_pass_s(inst: KernelInstance, pk: Peaks) -> float:
    """The splits' partials written at the card's rate and read back by
    the second pass at its blocks' share of it."""
    half = _partial_bytes(inst) / 2
    blocks = inst.second_pass_blocks or pk.sms
    return half / pk.hbm_bw + half / (pk.hbm_bw * min(1.0, blocks / pk.sms))


def hbm_bytes(inst: KernelInstance) -> int:
    """Modeled device-memory traffic: every block's operand reads, the
    output written once and the splits' partials written and read back."""
    reads = inst.blocks * sum(c.block_bytes for c in inst.copies)
    return reads + inst.out_bytes + _partial_bytes(inst)


def predict_s(inst: KernelInstance, pk: Peaks | None = None) -> float:
    """Predicted seconds for one launch (see the module's docstring)."""
    pk = pk or peaks()
    busiest = -(-inst.blocks // pk.sms)
    resident = min(busiest, inst.per_sm)
    # the busiest SM's share of each peak: its 1/sms, reached with enough
    # warps to issue and enough bytes in flight to cover the latency
    issue = min(1.0, resident * inst.threads / 32 / SATURATING_WARPS)
    little = pk.hbm_bw / pk.sms * LATENCY_S
    flight = min(1.0, resident * inst.inflight_bytes / little)
    reads = sum(c.block_bytes for c in inst.copies)
    t_ops = busiest * inst.block_ops * pk.sms / (pk.ops[inst.ops_dtype]
                                                 * issue)
    t_hbm = (busiest * reads * pk.sms / (pk.hbm_bw * flight)
             + inst.out_bytes / pk.hbm_bw)
    t_smem = busiest * inst.smem_traffic * pk.sms / (pk.smem_bw * issue)
    t_lat = -(-busiest // inst.per_sm) * inst.serial_steps * LATENCY_S
    return max(t_ops, t_hbm, t_smem, t_lat) + _second_pass_s(inst, pk)


def predict_us(family: str, shape: dict[str, Any],
               cand: dict[str, Any] | None = None, *,
               peaks_: Peaks | None = None, **extra) -> float | None:
    """Predicted µs for one (family, shape, candidate), or None where the
    family has no builder or the candidate builds no launch (the contract
    hook's degrade rule)."""
    builder = FAMILIES.get(family)
    if builder is None:
        return None
    try:
        inst = builder(**shape, **(cand or {}))
    except (TypeError, ValueError):
        return None
    if not inst.copies:  # a plan refused for its bytes: nothing launches
        return None
    return predict_s(inst, peaks_) * 1e6


def candidate_cost(family: str, shape: dict[str, Any], *,
                   peaks_: Peaks | None = None,
                   peaks_path: str | Path | None = None
                   ) -> Callable[[dict[str, Any]], float | None] | None:
    """The tuning hook: a ``candidate -> predicted µs`` callable for
    ranking a search best-predicted-first, or None for a family without a
    model. Peaks resolve once a search. A tuning entry of row 11 holds the
    forward's plan too (``rows``, ``stages``) and times both: its
    prediction adds the forward's."""
    if family not in FAMILIES:
        return None
    pk = peaks_ or peaks(peaks_path)
    if family == "conv1d_depthwise_bwd_dw":
        fwd = dict(shape, precision="fp")

        def predict(cand):
            bwd = predict_us(family, shape, cand, peaks_=pk)
            f = predict_us("conv1d_depthwise", fwd,
                           {k: cand[k] for k in ("rows", "stages")
                            if k in cand}, peaks_=pk)
            return None if bwd is None or f is None else bwd + f
        return predict

    def predict(cand: dict[str, Any]) -> float | None:
        return predict_us(family, shape, cand, peaks_=pk)

    return predict


# ---------------------------------------------------------------------------
# validate: predictions against the tuning cache's measured winners
# ---------------------------------------------------------------------------

_PRECISIONS = ("w8a8", "w8a16")


def parse_key(key: str) -> tuple[str, dict[str, Any]] | None:
    """(family, shape) of a tuning-cache key of the port, or None for a
    key the model does not cover. A quant key does not record the float
    type of x: float32 is taken."""
    parts = key.split("|")
    kind = parts[0]
    grad = parts[-1] == "grad"
    if grad:
        parts = parts[:-1]

    def num(tag: str, p: str) -> int:
        if not p.startswith(tag):
            raise ValueError(f"{p!r} is not {tag}<n>")
        return int(p[len(tag):])

    def types(field):
        return (("fp", field) if field not in _PRECISIONS
                else (field, "float32"))

    try:
        if kind == "conv1d" and len(parts) == 8:
            prec, dt = types(parts[7])
            shape = dict(B=num("B", parts[1]), L=num("L", parts[2]),
                         Cin=num("Cin", parts[3]), Cout=num("Cout", parts[4]),
                         K=num("K", parts[5]), stride=num("s", parts[6]))
            if grad:
                return "conv1d_bwd_dw", dict(shape, dtype=dt)
            return "conv1d", dict(shape, precision=prec, dtype=dt)
        if kind == "conv2d" and len(parts) == 9:
            prec, dt = types(parts[8])
            kh, kw = (int(v) for v in parts[6][1:].split("x"))
            sh, sw = (int(v) for v in parts[7][1:].split("x"))
            shape = dict(B=num("B", parts[1]), H=num("H", parts[2]),
                         W=num("W", parts[3]), Cin=num("Cin", parts[4]),
                         Cout=num("Cout", parts[5]), kh=kh, kw=kw,
                         stride=(sh, sw))
            if grad:
                return "conv2d_bwd_dw", dict(shape, dtype=dt)
            return "conv2d", dict(shape, precision=prec, dtype=dt)
        if kind == "conv1ddw" and len(parts) == 7:
            prec, dt = types(parts[6])
            return "conv1d_depthwise", dict(
                B=num("B", parts[1]), L=num("L", parts[2]),
                C=num("C", parts[3]), K=num("K", parts[4]),
                stride=num("s", parts[5]), precision=prec, dtype=dt)
        if kind == "attn_dec" and len(parts) == 7:
            return "attention_decode", dict(
                B=num("B", parts[1]), S=num("S", parts[2]),
                KV=num("KV", parts[3]), G=num("G", parts[4]),
                D=num("D", parts[5]), kind=parts[6])
        if kind == "pool1d" and len(parts) == 7:
            return "pool1d", dict(
                B=num("B", parts[1]), L=num("L", parts[2]),
                C=num("C", parts[3]), window=num("w", parts[4]), op=parts[5],
                dtype=parts[6])
    except ValueError:
        return None
    return None


#: entry fields that are measurements, not plan fields
_ENTRY_META = {"us", "default_us", "dispatch_us"}
_DW_BWD = ("bwd_rows", "bwd_stages", "bwd_splits")


def cache_rows(cache: dict
               ) -> Iterable[tuple[str, str, dict, dict, float]]:
    """(family, key, shape, candidate, measured µs) of every tuned entry
    the model covers. A depthwise entry with row 11's fields was timed
    forward and backward: it counts under ``conv1d_depthwise_bwd_dw``."""
    for key, entry in cache.items():
        if key.startswith("__") or not isinstance(entry, dict):
            continue
        us = entry.get("us")
        if not isinstance(us, (int, float)) or us <= 0:
            continue
        parsed = parse_key(key)
        if parsed is None:
            continue
        family, shape = parsed
        cand = {k: v for k, v in entry.items() if k not in _ENTRY_META}
        if family == "conv1d_depthwise" and any(f in cand for f in _DW_BWD):
            family = "conv1d_depthwise_bwd_dw"
            shape = {k: v for k, v in shape.items() if k != "precision"}
        yield family, key, shape, cand, float(us)


def _rank(xs: list[float]) -> list[float]:
    """Average ranks (ties share the mean rank)."""
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    ranks = [0.0] * len(xs)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        for k in range(i, j + 1):
            ranks[order[k]] = (i + j) / 2.0
        i = j + 1
    return ranks


def spearman(xs: list[float], ys: list[float]) -> float:
    """Spearman rank correlation (average-rank ties)."""
    if len(xs) != len(ys) or len(xs) < 2:
        return 0.0
    rx, ry = _rank(xs), _rank(ys)
    mx, my = sum(rx) / len(rx), sum(ry) / len(ry)
    cov = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    vx = sum((a - mx) ** 2 for a in rx)
    vy = sum((b - my) ** 2 for b in ry)
    if vx == 0 or vy == 0:
        return 0.0
    return cov / math.sqrt(vx * vy)


def mape(preds: list[float], meas: list[float]) -> float:
    return sum(abs(p - m) / m for p, m in zip(preds, meas)) / len(preds)


def _load_cache(cache) -> dict:
    if cache is None:
        from repro_torch.kernels import autotune

        cache = autotune.cache_path()
    if isinstance(cache, dict):
        return cache
    try:
        got = json.loads(Path(cache).read_text())
    except (OSError, ValueError):
        return {}
    return got if isinstance(got, dict) else {}


def validate(cache: dict | str | Path | None = None, *,
             peaks_: Peaks | None = None,
             peaks_path: str | Path | None = None
             ) -> tuple[list[Violation], dict[str, Any]]:
    """Hold the predictions to every measured winner of the tuning cache
    (``autotune.cache_path()`` by default), per family: MAPE (reported:
    the peaks are coarse) and Spearman ρ (gated at ``SPEARMAN_GATE`` for
    a family of at least ``GATE_MIN_ROWS`` rows)."""
    pk = peaks_ or peaks(peaks_path)
    fams: dict[str, dict[str, list]] = {}
    skipped = 0
    for family, key, shape, cand, meas in cache_rows(_load_cache(cache)):
        pred = candidate_cost(family, shape, peaks_=pk)
        p = pred(cand) if pred is not None else None
        if p is None:
            skipped += 1
            continue
        f = fams.setdefault(family, {"pred": [], "meas": [], "keys": []})
        f["pred"].append(p)
        f["meas"].append(meas)
        f["keys"].append(key)
    violations: list[Violation] = []
    stats: dict[str, Any] = {}
    for family, f in sorted(fams.items()):
        rho = spearman(f["pred"], f["meas"])
        gated = len(f["pred"]) >= GATE_MIN_ROWS
        stats[family] = {"n": len(f["pred"]), "mape": round(mape(
            f["pred"], f["meas"]), 3), "spearman": round(rho, 3),
            "gated": gated}
        if gated and rho < SPEARMAN_GATE:
            violations.append(Violation(
                "cost_rank", family, f"rho={rho:.3f}",
                f"prediction order disagrees with measurement over "
                f"{len(f['pred'])} tuned rows (gate {SPEARMAN_GATE}): ranked "
                f"search would stop early on a lying prior"))
    return violations, {"rows": sum(len(f["pred"]) for f in fams.values()),
                        "skipped": skipped, "families": stats,
                        "peaks": pk.as_stats()}


def check_all(*, quick: bool = False, peaks_path: str | Path | None = None,
              cache: dict | str | Path | None = None
              ) -> tuple[list[Violation], dict[str, Any]]:
    """Predict every instance of the contract key space (a prediction that
    is not finite and positive is a ``cost_model`` violation), then
    :func:`validate` against the tuning cache."""
    pk = peaks(peaks_path)
    violations: list[Violation] = []
    n = 0
    fam_pred: dict[str, list[float]] = {}
    for family, shape, cand in default_space(quick=quick):
        pred = predict_us(family, shape, cand, peaks_=pk)
        n += 1
        if pred is None or not math.isfinite(pred) or pred <= 0:
            violations.append(Violation(
                "cost_model", family, str(shape),
                f"prediction {pred!r} for candidate {cand}: it must be "
                f"finite and positive for every contract instance"))
            continue
        fam_pred.setdefault(family, []).append(pred)
    stats: dict[str, Any] = {
        "instances": n, "peaks": pk.as_stats(),
        "pred_us": {fam: {"min": round(min(p), 3), "max": round(max(p), 1)}
                    for fam, p in sorted(fam_pred.items())},
    }
    v2, vstats = validate(cache, peaks_=pk, peaks_path=peaks_path)
    violations.extend(v2)
    stats["validate"] = vstats
    return violations, stats
