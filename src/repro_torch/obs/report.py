"""Render the human run summary from persisted obs artifacts.

``python -m repro_torch.obs report <run_dir>`` reads ``metrics.json`` (and
notes ``trace.json`` when present) and reprints the ``[serve]`` /
``[train]`` summary the live CLIs emit — same line formats, so the
summary of a finished run is reconstructable from artifacts alone
(as ``repro.obs.report`` renders it). Sections render only when
their metrics exist, so one CLI serves serve runs, train runs, and
benchmark provenance snapshots alike.
"""
from __future__ import annotations

import os

from repro_torch.obs.metrics import Registry, hist_quantile


def _counter(snap: dict, name: str) -> list[dict]:
    return snap.get("counters", {}).get(name, [])


def _gauge_value(snap: dict, name: str, **labels) -> float | None:
    want = {k: str(v) for k, v in labels.items()}
    for s in snap.get("gauges", {}).get(name, []):
        if s["labels"] == want:
            return s["value"]
    return None


def _fmt_s(v: float) -> str:
    """Human duration: seconds above 1 s, milliseconds below."""
    return f"{v:.2f}s" if v >= 1.0 else f"{v * 1e3:.2f}ms"


def _hist_lines(snap: dict, name: str, label: str) -> list[str]:
    """One quantile line per label set of a histogram."""
    out = []
    bounds = snap.get("bounds", [])
    for s in snap.get("histograms", {}).get(name, []):
        if not s["count"]:
            continue
        p50 = hist_quantile(bounds, s["buckets"], 0.50)
        p95 = hist_quantile(bounds, s["buckets"], 0.95)
        p99 = hist_quantile(bounds, s["buckets"], 0.99)
        lab = "".join(
            f" {k}={v}" for k, v in sorted(s["labels"].items())
        )
        out.append(
            f"{label}: p50={_fmt_s(p50)} p95={_fmt_s(p95)} "
            f"p99={_fmt_s(p99)} (n={s['count']}{lab})"
        )
    return out


def _serve_lines(snap: dict) -> list[str]:
    lines: list[str] = []
    run = snap.get("facts", {}).get("serve.run", {})
    if run.get("shape"):
        lines.append(
            f"[serve] generated {run['shape']} "
            f"in {run.get('elapsed_s', '?')}s "
            f"({run.get('tok_per_s', '?')} tok/s); "
            f"{run.get('recyclable', '?')}/{run.get('batch', '?')} "
            f"slots recyclable (eos={run.get('eos_id', '?')})"
        )
    # attn-decode dispatch: impl per key from the facts mirror, hit count
    # from the dispatch.log_calls counter — the same data the live
    # `calls=N` lines printed
    impls = snap.get("facts", {}).get("dispatch.attn_decode", {})
    calls = {
        s["labels"].get("key"): s["value"]
        for s in _counter(snap, "dispatch.log_calls")
        if s["labels"].get("log") == "attn_decode"
    }
    for key in sorted(impls):
        lines.append(
            f"[serve] attn-decode: impl={impls[key]} key={key} "
            f"calls={int(calls.get(key, 0))}"
        )
    served = _gauge_value(snap, "serve.kv_cache_bytes", kind="served")
    fp = _gauge_value(snap, "serve.kv_cache_bytes", kind="fp")
    if served and fp:
        lines.append(
            f"[serve] kv-cache bytes: {int(served)} "
            f"(fp {int(fp)}, ratio {fp / served:.2f}x)"
        )
    if run.get("sample"):
        lines.append(f"[serve] sample: {run['sample']}")
    for s in _counter(snap, "health.events"):
        lb, n = s["labels"], int(s["value"])
        extra = f" x{n}" if n > 1 else ""
        lines.append(
            f"[serve] health: site={lb.get('site')} "
            f"reason={lb.get('reason')} action={lb.get('action')}{extra}"
        )
    for ln in _hist_lines(snap, "serve.ttft_s", "ttft"):
        lines.append(f"[serve] {ln}")
    for ln in _hist_lines(snap, "serve.decode_step_s", "decode-step"):
        lines.append(f"[serve] {ln}")
    return lines


def _dispatch_lines(snap: dict, top: int = 10) -> list[str]:
    """Per-autotune-key dispatch table, heaviest wall time first."""
    calls = {
        tuple(sorted(s["labels"].items())): s["value"]
        for s in _counter(snap, "dispatch.calls")
    }
    secs = {
        tuple(sorted(s["labels"].items())): s["value"]
        for s in _counter(snap, "dispatch.seconds_total")
    }
    hbm = {
        tuple(sorted(s["labels"].items())): s["value"]
        for s in _counter(snap, "dispatch.est_hbm_bytes_total")
    }
    rows = sorted(secs.items(), key=lambda kv: -kv[1])[:top]
    lines = []
    for lkey, total in rows:
        lb = dict(lkey)
        extra = ""
        if lkey in hbm:
            extra = f" est-hbm={int(hbm[lkey]):,}B"
        lines.append(
            f"[dispatch] key={lb.get('key')} rung={lb.get('rung')} "
            f"calls={int(calls.get(lkey, 0))} "
            f"total={_fmt_s(total)}{extra}"
        )
    dropped = len(secs) - len(rows)
    if dropped > 0:
        lines.append(f"[dispatch] ({dropped} more key(s) not shown)")
    return lines


def _train_lines(snap: dict) -> list[str]:
    lines: list[str] = []
    steps = sum(s["value"] for s in _counter(snap, "train.steps"))
    if steps:
        tokens = sum(s["value"] for s in _counter(snap, "train.tokens"))
        loss_series = snap.get("gauges", {}).get("train.loss", [])
        loss = loss_series[0]["value"] if loss_series else None
        loss_txt = f" final-loss={loss:.4f}" if loss is not None else ""
        lines.append(
            f"[train] steps={int(steps)} tokens={int(tokens)}{loss_txt}"
        )
        for ln in _hist_lines(snap, "train.step_s", "step"):
            lines.append(f"[train] {ln}")
        for ln in _hist_lines(snap, "train.ckpt_save_s", "ckpt-save"):
            lines.append(f"[train] {ln}")
        resumes = sum(s["value"] for s in _counter(snap, "train.resumes"))
        if resumes:
            lines.append(f"[train] resumes={int(resumes)}")
    return lines


def render(run_dir) -> list[str]:
    """Report lines for a run directory holding ``metrics.json``."""
    run_dir = os.fspath(run_dir)
    path = os.path.join(run_dir, "metrics.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no metrics.json under {run_dir!r}")
    snap = Registry.load(path)
    lines = [f"[obs] report for {run_dir} (schema {snap['schema']})"]
    trace_path = os.path.join(run_dir, "trace.json")
    if os.path.exists(trace_path):
        import json

        with open(trace_path) as f:
            n = len(json.load(f).get("traceEvents", []))
        lines.append(f"[obs] trace.json: {n} events (Perfetto-loadable)")
    lines += _serve_lines(snap)
    lines += _dispatch_lines(snap)
    lines += _train_lines(snap)
    if len(lines) == 1:
        lines.append("[obs] (no serve/train/dispatch series in snapshot)")
    return lines


def report(run_dir) -> None:
    for line in render(run_dir):
        print(line, flush=True)
