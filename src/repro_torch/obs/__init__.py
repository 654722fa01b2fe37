"""``repro_torch.obs``: stdlib-only observability, a copy of ``repro.obs``
with the same names, formats and artifacts, so a run of either package is
read by either package's report.

Two surfaces behind frozen name vocabularies (``obs.names``):

  * **tracing** (``obs.span`` / ``obs.traced`` / ``obs.instant``) into a
    bounded ring buffer, exported as Chrome/Perfetto ``trace.json``.
    Armed via ``REPRO_TRACE=1`` or ``--trace``; a single flag check and
    a shared null context manager when off.
  * **metrics** (``obs.metrics.REGISTRY``: counters, gauges,
    fixed-bucket latency histograms with deterministic quantiles, facts
    tables) snapshotted to ``metrics.json`` + a Prometheus text
    exposition under ``run_dir``.

``python -m repro_torch.obs report <run_dir>`` renders the human summary
from the persisted artifacts. The package imports nothing from the rest of
``repro_torch``: ``health`` (itself import-light) mirrors into it without
cycles.
"""
from __future__ import annotations

from repro_torch.obs import logs, metrics, names, trace
from repro_torch.obs.logs import debug, info, log, set_level, warn
from repro_torch.obs.metrics import (
    BOUNDS,
    REGISTRY,
    DispatchLog,
    dispatch_enabled,
    enable_dispatch,
    hist_quantile,
)
from repro_torch.obs.trace import enable, enabled, instant, span, traced

__all__ = [
    "BOUNDS", "REGISTRY", "DispatchLog", "debug", "dispatch_enabled",
    "enable", "enable_dispatch", "enabled", "hist_quantile", "info",
    "instant", "log", "logs", "metrics", "names", "set_level", "span",
    "trace", "traced", "warn", "write_artifacts",
]


def write_artifacts(run_dir) -> list[str]:
    """Persist the run's observability artifacts under ``run_dir``:
    ``metrics.json`` + ``metrics.prom`` always, ``trace.json`` when
    tracing is armed. Returns the written paths."""
    import os

    paths = [REGISTRY.write(run_dir)]
    paths.append(os.path.join(os.fspath(run_dir), "metrics.prom"))
    if trace.enabled():
        paths.append(trace.export(
            os.path.join(os.fspath(run_dir), "trace.json")
        ))
    return paths
