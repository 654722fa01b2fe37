"""Health record: reason-coded degradation events.

The event-log part of ``repro.health``: when a site degrades (a quantized
conv served in floating point because its calibrated scale is unusable, a
requant chain broken at a poisoned scale, a decode slot quarantined, a
request truncated at its deadline or shed at admission) the event lands
here with a reason code from a closed vocabulary. ``record`` deduplicates
by (site, reason, action), prints the first occurrence to stderr, and
mirrors every event into the obs ``health.events`` counter and, while
tracing is armed, a ``health.event`` instant; the serve CLI prints
``summary()`` as its ``health:`` lines.

Not ported: the reference's per-(site, impl) circuit breakers. The port has
no ladder of compiled twins to demote along: a CUDA tensor goes to its
kernel or the call raises.
"""
from __future__ import annotations

import dataclasses
import sys
import threading

from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

# the reference's reason codes that the port's code paths can produce
REASONS = frozenset({
    "quant_scale_zero", "quant_scale_nan",
    # quant dispatch: a tuned quant path slower than the float one
    "quant_slower",
    # tuning cache quarantine
    "cache_corrupt", "cache_schema_mismatch",
    # serving
    "deadline_exceeded", "straggler", "nan_logits", "load_shed",
    # exceptions with no mapped kind (the class name goes in ``detail``)
    "runtime_error",
})


def canon_reason(exc: BaseException, default: str | None = None) -> str:
    """The reason code for an exception, as ``repro.health.canon_reason``
    gives it: a valid ``exc.kind``, then ``FloatingPointError`` ->
    ``nan_logits``, then ``default`` if it is a valid reason, else
    ``runtime_error``."""
    kind = getattr(exc, "kind", None)
    if kind in REASONS:
        return kind
    if isinstance(exc, FloatingPointError):
        return "nan_logits"
    if default in REASONS:
        return default
    return "runtime_error"


@dataclasses.dataclass
class HealthEvent:
    """One event: where (``site``), why (``reason``), what was done
    (``action``), free-form ``detail``, and how often (``count``)."""

    site: str
    reason: str
    action: str
    detail: str = ""
    count: int = 1

    def line(self) -> str:
        extra = f" x{self.count}" if self.count > 1 else ""
        det = f" ({self.detail})" if self.detail else ""
        return (f"site={self.site} reason={self.reason} "
                f"action={self.action}{extra}{det}")


class Health:
    """Process-global, append-only, deduplicated event log."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.events: list[HealthEvent] = []

    def record(self, site: str, reason: str, action: str,
               detail: str = "") -> HealthEvent:
        """Log one event; a repeat of (site, reason, action) bumps its
        count. Every call, repeats too, mirrors into obs. Unknown reason
        codes raise."""
        if reason not in REASONS:
            raise ValueError(f"unknown health reason {reason!r} at site {site!r}")
        with self._lock:
            ev = next((e for e in self.events
                       if (e.site, e.reason, e.action) == (site, reason, action)),
                      None)
            if ev is None:
                ev = HealthEvent(site, reason, action, detail)
                self.events.append(ev)
            else:
                ev.count += 1
        _obs_metrics.REGISTRY.counter("health.events").inc(
            1.0, site=site, reason=reason, action=action)
        _obs_trace.instant("health.event", site=site, reason=reason,
                           action=action)
        if ev.count == 1:
            print(f"[health] {ev.line()}", file=sys.stderr)
        return ev

    def reset(self) -> None:
        with self._lock:
            self.events.clear()

    def summary(self) -> list[str]:
        """One formatted line per distinct event."""
        return [ev.line() for ev in self.events]


#: The process-global record.
HEALTH = Health()
