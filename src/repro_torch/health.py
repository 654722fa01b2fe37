"""Health record: reason-coded degradation events and circuit breakers.

``repro.health`` in the port. The robustness layer never falls back
silently: when a site degrades (a kernel rung demoted down the ``ops``
ladder, a quantized conv served in floating point because its calibrated
scale is unusable, a requant chain broken at a poisoned scale, a corrupt
tuning cache quarantined, a decode slot quarantined, a request truncated
at its deadline or shed at admission) the event lands here with a reason
code from the closed :class:`Reason` vocabulary.

Two kinds of state:

  * **events**: an append-only ``HealthEvent`` log. ``record``
    deduplicates by (site, reason, action), prints the first occurrence to
    stderr, and mirrors every event into the obs ``health.events`` counter
    and, while tracing is armed, a ``health.event`` instant; the serve CLI
    prints ``summary()`` as its ``health:`` lines.
  * **demotions**: a circuit breaker per ``(site, rung)``. ``ops._ladder``
    opens one when an injected fault (``repro_torch.faults``) fails a rung,
    and serve's and train's catch layers when an injected runtime trip
    names one. Nothing else opens a breaker: the ladder lets every other
    error propagate, and a trip of the non-finite sentinel (a rung's own
    output, nothing injected) is recorded and fails its request or step
    (``demote_tripped``). A demotion is not for the life of the
    process: after a cooldown (clean calls at the site and loop ticks, or
    wall-clock seconds, both growing with the trip count) the rung gets
    one probation call through the ladder. A probe that serves cleanly
    repromotes it (a ``repromote`` event and the ``health.repromote``
    counter); a probe that fails re-demotes it with a longer cooldown.
    The trip count survives repromotion.

Cooldown knobs, read at check time:

  ``REPRO_HEALTH_COOLDOWN_CALLS``  clean calls before a probe (default 64;
                                   ``0`` turns the call count off)
  ``REPRO_HEALTH_COOLDOWN_S``      seconds before a probe (unset: calls
                                   only)
  ``REPRO_HEALTH_COOLDOWN_GROWTH`` factor per trip (default 2.0)

``has_breakers`` is a plain attribute, True while any breaker exists: the
ladder's disarmed path reads it without the lock.
"""
from __future__ import annotations

import dataclasses
import enum
import os
import sys
import threading
import time

from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace


class Reason(str, enum.Enum):
    """The reference's frozen vocabulary of reason codes, by producer.
    Members are str-valued, so ``ev.reason == "pallas_compile"`` holds."""

    # fault-injection kinds (repro_torch.faults), as ``FaultError.kind``
    PALLAS_COMPILE = "pallas_compile"
    PALLAS_RUNTIME = "pallas_runtime"
    JAX_RUNTIME = "jax_runtime"
    NAN_ACTIVATIONS = "nan_activations"
    QUANT_SCALE_ZERO = "quant_scale_zero"
    QUANT_SCALE_NAN = "quant_scale_nan"
    AUTOTUNE_CORRUPT = "autotune_corrupt"
    CKPT_CORRUPT = "ckpt_corrupt"
    CKPT_WRITE_STALL = "ckpt_write_stall"
    HEARTBEAT_STALE = "heartbeat_stale"
    SLOW_STEP = "slow_step"
    # ladder rung failures without a fault kind (the reference's ladder;
    # the port's ladder demotes on fault kinds only)
    PALLAS_ERROR = "pallas_error"
    JAX_ERROR = "jax_error"
    REF_ERROR = "ref_error"
    # quant dispatch
    QUANT_SLOWER = "quant_slower"
    # tuning cache quarantine
    CACHE_CORRUPT = "cache_corrupt"
    CACHE_SCHEMA_MISMATCH = "cache_schema_mismatch"
    # checkpointing
    CKPT_INVALID = "ckpt_invalid"
    # serving
    DEADLINE_EXCEEDED = "deadline_exceeded"
    STRAGGLER = "straggler"
    NAN_LOGITS = "nan_logits"
    LOAD_SHED = "load_shed"
    # training restarts
    RESTARTS_EXHAUSTED = "restarts_exhausted"
    STEP_CRASH = "step_crash"
    # exceptions with no mapped kind (the class name goes in ``detail``)
    RUNTIME_ERROR = "runtime_error"


def _valid(reason) -> str | None:
    try:
        return Reason(reason).value
    except ValueError:
        return None


def canon_reason(exc: BaseException, default: str | None = None) -> str:
    """The reason code for an exception, as ``repro.health.canon_reason``
    gives it: a valid ``exc.kind``, then ``FloatingPointError`` ->
    ``nan_logits``, then ``default`` if it is a valid reason, else
    ``runtime_error``."""
    kind = _valid(getattr(exc, "kind", None))
    if kind is not None:
        return kind
    if isinstance(exc, FloatingPointError):
        return Reason.NAN_LOGITS.value
    return _valid(default) or Reason.RUNTIME_ERROR.value


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


def _cooldown_calls() -> int:
    try:
        return int(os.environ.get("REPRO_HEALTH_COOLDOWN_CALLS", "64"))
    except ValueError:
        return 64


def _cooldown_s() -> float | None:
    raw = os.environ.get("REPRO_HEALTH_COOLDOWN_S")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def _cooldown_growth() -> float:
    try:
        return float(os.environ.get("REPRO_HEALTH_COOLDOWN_GROWTH", "2.0"))
    except ValueError:
        return 2.0


@dataclasses.dataclass
class Breaker:
    """Circuit-breaker state of one demoted ``(site, impl)`` rung.

    ``open``: demoted, the ladder skips the rung. ``probing``: the cooldown
    elapsed and one dispatch holds the rung as its probe; that dispatch
    repromotes it (``note_success``) or re-opens it (``demote``)."""

    site: str
    impl: str
    reason: str = Reason.RUNTIME_ERROR.value
    trips: int = 1       # demotions so far: the cooldown grows with them
    clean: int = 0       # clean calls at the site (and ticks) since the trip
    since: float = 0.0   # perf_counter at the trip
    state: str = "open"

    def _growth(self) -> float:
        # the exponent saturates instead of overflowing
        return _cooldown_growth() ** min(self.trips - 1, 16)

    def ready(self, now: float) -> bool:
        """The cooldown elapsed: the rung may take its probation call."""
        cd_s = _cooldown_s()
        if cd_s is not None and now - self.since >= cd_s * self._growth():
            return True
        calls = _cooldown_calls()
        return calls > 0 and self.clean >= calls * self._growth()


class Health:
    """Process-global event log and per-(site, impl) circuit breakers."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.events: list[HealthEvent] = []
        self._breakers: dict[tuple[str, str], Breaker] = {}
        # trip counts survive repromotion: a flapping rung keeps its grown
        # cooldown
        self._trip_history: dict[tuple[str, str], int] = {}
        self.has_breakers = False

    # -- events ---------------------------------------------------------------
    def record(self, site: str, reason: str, action: str,
               detail: str = "") -> HealthEvent:
        """Log one event; a repeat of (site, reason, action) bumps its
        count. Every call, repeats too, mirrors into obs. A reason outside
        :class:`Reason` raises."""
        valid = _valid(reason)
        if valid is None:
            raise ValueError(
                f"unknown health reason {reason!r} at site {site!r}: add it "
                f"to health.Reason or canonicalize via canon_reason")
        reason = valid
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

    def events_for(self, site: str | None = None,
                   reason: str | None = None) -> list[HealthEvent]:
        return [ev for ev in self.events
                if (site is None or ev.site == site)
                and (reason is None or ev.reason == reason)]

    # -- demotions ------------------------------------------------------------
    def demote(self, site: str, impl: str,
               reason: str = Reason.RUNTIME_ERROR.value) -> None:
        """Open the breaker of ``impl`` at ``site``. A repeat trip (or a
        failed probe) re-opens it with ``trips + 1``."""
        key = (site, impl)
        reason = _valid(reason) or Reason.RUNTIME_ERROR.value
        now = time.perf_counter()
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = Breaker(site, impl, reason=reason,
                             trips=self._trip_history.get(key, 0) + 1,
                             since=now)
                self._breakers[key] = br
            else:
                br.trips += 1
                br.clean = 0
                br.since = now
                br.state = "open"
                br.reason = reason
            self._trip_history[key] = br.trips
            self.has_breakers = True

    def is_demoted(self, site: str, impl: str) -> bool:
        """The breaker check and the probation gate: the first call after
        the cooldown is granted the rung (False once, state ``probing``),
        and that dispatch resolves the grant."""
        with self._lock:
            br = self._breakers.get((site, impl))
            if br is None:
                return False
            if br.state == "probing":
                return True  # the one probe is already out
            if not br.ready(time.perf_counter()):
                return True
            br.state = "probing"
        self.record(site, br.reason, f"probe:{impl}",
                    detail=f"trip {br.trips}, clean {br.clean}")
        return False

    def note_success(self, site: str, impl: str) -> None:
        """``impl`` served ``site`` cleanly: every open breaker at the site
        gains a clean call, and a probing ``impl`` repromotes."""
        if not self.has_breakers:
            return
        repromoted = None
        with self._lock:
            for (s, i), br in list(self._breakers.items()):
                if s != site:
                    continue
                if i == impl and br.state == "probing":
                    del self._breakers[(s, i)]
                    repromoted = br
                elif br.state == "open":
                    br.clean += 1
            self.has_breakers = bool(self._breakers)
        if repromoted is not None:
            self.record(site, repromoted.reason, f"repromote:{impl}",
                        detail=f"after trip {repromoted.trips}")
            _obs_metrics.REGISTRY.counter("health.repromote").inc(
                1.0, site=site, rung=impl)

    def tick(self, n: int = 1) -> None:
        """Clean-call credit from a serving or training loop step, so a
        call-count cooldown runs while the demoted site is not called."""
        with self._lock:
            for br in self._breakers.values():
                if br.state == "open":
                    br.clean += n

    def probation_ready(self) -> list[tuple[str, str]]:
        """(site, impl) pairs whose cooldown elapsed and that no dispatch
        has probed yet."""
        now = time.perf_counter()
        with self._lock:
            return [(br.site, br.impl) for br in self._breakers.values()
                    if br.state == "open" and br.ready(now)]

    def demotions(self) -> dict[str, frozenset[str]]:
        with self._lock:
            out: dict[str, set[str]] = {}
            for s, i in self._breakers:
                out.setdefault(s, set()).add(i)
            return {s: frozenset(v) for s, v in out.items()}

    def breaker(self, site: str, impl: str) -> Breaker | None:
        """The live breaker of ``(site, impl)``, else None."""
        with self._lock:
            return self._breakers.get((site, impl))

    # -- lifecycle ------------------------------------------------------------
    def reset(self) -> None:
        """Clear events, breakers and trip history."""
        with self._lock:
            self.events.clear()
            self._breakers.clear()
            self._trip_history.clear()
            self.has_breakers = False

    def summary(self) -> list[str]:
        """One formatted line per distinct event."""
        return [ev.line() for ev in self.events]


#: The process-global record.
HEALTH = Health()


def demote_tripped(trip, exc: BaseException, where: str = "") -> bool:
    """The runtime catch layers' answer to a trip (serve's and train's).
    An injected trip records ``demote:<rung>(runtime)`` at its site, opens
    the rung's breaker, counts ``runtime.demote`` under (site, rung, key)
    and returns True: the caller re-runs on the next rung. A trip of the
    sentinel (``trip.injected`` False: the rung really emitted a
    non-finite value) records ``error:<rung>(sentinel)``, demotes nothing
    and returns False: the caller lets the error propagate, since serving
    a faulty kernel's site from the plain version would hide the fault.
    The trip's kind is the reason where it is a valid one."""
    reason = _valid(trip.kind) or canon_reason(exc)
    key = trip.key or trip.site
    detail = f"key={key}{where} {repr(exc)[:160]}"
    if not trip.injected:
        HEALTH.record(trip.site, reason, f"error:{trip.rung}(sentinel)",
                      detail=detail)
        return False
    HEALTH.record(trip.site, reason, f"demote:{trip.rung}(runtime)",
                  detail=detail)
    HEALTH.demote(trip.site, trip.rung, reason=reason)
    _obs_metrics.REGISTRY.counter("runtime.demote").inc(
        1.0, site=trip.site, rung=trip.rung, key=key)
    return True
