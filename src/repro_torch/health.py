"""Health record: reason-coded degradation events.

The event-log part of ``repro.health``: when a site degrades (a quantized
conv served in floating point because its calibrated scale is unusable, a
requant chain broken at a poisoned scale) the event lands here with a
reason code from a closed vocabulary. ``record`` deduplicates by
(site, reason, action) and prints the first occurrence to stderr; the serve
CLI prints ``summary()`` as its ``health:`` lines.

Not ported: the reference's per-(site, impl) circuit breakers. The port has
no ladder of compiled twins to demote along: a CUDA tensor goes to its
kernel or the call raises.
"""
from __future__ import annotations

import dataclasses
import sys
import threading

# the reference's reason codes that the port's code paths can produce
REASONS = frozenset({"quant_scale_zero", "quant_scale_nan"})


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
        count. Unknown reason codes raise."""
        if reason not in REASONS:
            raise ValueError(f"unknown health reason {reason!r} at site {site!r}")
        with self._lock:
            for ev in self.events:
                if (ev.site, ev.reason, ev.action) == (site, reason, action):
                    ev.count += 1
                    return ev
            ev = HealthEvent(site, reason, action, detail)
            self.events.append(ev)
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
