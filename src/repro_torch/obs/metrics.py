"""Metrics: counters, gauges, fixed-bucket latency histograms, and
string-valued facts tables, behind one process-global :data:`REGISTRY`.

Metric names come from the frozen ``obs.names.METRICS`` vocabulary —
the registry raises on anything else. Series are labeled with the
repo's existing vocabularies (dispatch site, autotune shape key, rung
``cuda`` or ``plain``, health reason/action, arch) and label values are
canonicalized to strings so a snapshot round-trips through JSON
losslessly.

Histograms use FIXED 1-2-5 log-spaced latency buckets (1 µs … 500 s):
every process bins into the same grid, so p50/p95/p99 are deterministic
functions of the persisted bucket counts (:func:`hist_quantile`, linear
interpolation within the bucket) — two machines aggregating snapshots
can never disagree on the quantile math.

``snapshot()`` / ``write(run_dir)`` persist ``metrics.json`` (the report
CLI's input) plus a Prometheus-style text exposition ``metrics.prom``.

The module also hosts :class:`DispatchLog`: the dedup-counted
``key → (last value, hit count)`` mapping ``kernels.ops`` uses for
``ATTN_DECODE_DISPATCH`` and its other dispatch logs. A *named* log mirrors
every hit into the registry (``dispatch.log_calls`` + a facts table) so
serve's ``calls=N`` lines are reconstructable from ``metrics.json``
alone; an unnamed log is the plain mapping it always was.
"""
from __future__ import annotations

import json
import os
import threading

from repro_torch.obs import names

#: arm flag for the dispatch instrumentation of the ``kernels.ops`` entry
#: points (separate from tracing: a benchmark wants the per-key dispatch
#: counters without paying for span buffering)
DISPATCH_ON: bool = os.environ.get("REPRO_METRICS", "") not in ("", "0")

#: snapshot schema version (bump on incompatible layout changes)
SCHEMA = 1

#: fixed 1-2-5 log-spaced bucket upper bounds, seconds (1 µs … 500 s);
#: observations above the last bound land in the +Inf overflow bucket
BOUNDS: tuple[float, ...] = tuple(
    m * 10.0 ** e for e in range(-6, 3) for m in (1.0, 2.0, 5.0)
)

_LOCK = threading.RLock()


def enable_dispatch(on: bool = True) -> None:
    """Arm the ``kernels.ops`` dispatch counters for this process."""
    global DISPATCH_ON
    DISPATCH_ON = bool(on)


def dispatch_enabled() -> bool:
    return DISPATCH_ON


def _lkey(labels: dict) -> tuple:
    """Canonical hashable series key: sorted (key, str(value)) pairs."""
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def hist_quantile(bounds, counts, q: float) -> float:
    """Deterministic quantile from persisted bucket counts.

    ``counts`` has ``len(bounds) + 1`` entries (the last is the +Inf
    overflow). Linear interpolation within the target bucket, from its
    lower bound (0 for the first); the overflow bucket reports the last
    finite bound — a floor, honestly saturated.
    """
    total = sum(counts)
    if total == 0:
        return 0.0
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            if i >= len(bounds):  # overflow bucket
                return float(bounds[-1])
            lo = 0.0 if i == 0 else float(bounds[i - 1])
            hi = float(bounds[i])
            frac = (target - cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
    return float(bounds[-1])


class Counter:
    """Monotonically increasing sum per label set."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._series: dict[tuple, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        k = _lkey(labels)
        with _LOCK:
            self._series[k] = self._series.get(k, 0.0) + n

    def value(self, **labels) -> float:
        return self._series.get(_lkey(labels), 0.0)

    def series(self) -> list[tuple[dict, float]]:
        with _LOCK:
            return [(dict(k), v) for k, v in self._series.items()]

    def _drop(self, label: str, value: str) -> None:
        """Remove every series whose ``label`` equals ``value``."""
        with _LOCK:
            for k in [k for k in self._series if (label, str(value)) in k]:
                del self._series[k]


class Gauge:
    """Last-set value per label set."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._series: dict[tuple, float] = {}

    def set(self, v: float, **labels) -> None:
        with _LOCK:
            self._series[_lkey(labels)] = float(v)

    def value(self, **labels) -> float | None:
        return self._series.get(_lkey(labels))

    def series(self) -> list[tuple[dict, float]]:
        with _LOCK:
            return [(dict(k), v) for k, v in self._series.items()]


class Histogram:
    """Fixed-bucket latency histogram (seconds) per label set."""

    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        # lkey -> [bucket counts (len(BOUNDS)+1), sum, count]
        self._series: dict[tuple, list] = {}

    def observe(self, v: float, **labels) -> None:
        v = float(v)
        k = _lkey(labels)
        with _LOCK:
            ent = self._series.get(k)
            if ent is None:
                ent = [[0] * (len(BOUNDS) + 1), 0.0, 0]
                self._series[k] = ent
            i = 0
            while i < len(BOUNDS) and v > BOUNDS[i]:
                i += 1
            ent[0][i] += 1
            ent[1] += v
            ent[2] += 1

    def quantile(self, q: float, **labels) -> float:
        ent = self._series.get(_lkey(labels))
        if ent is None:
            return 0.0
        return hist_quantile(BOUNDS, ent[0], q)

    def count(self, **labels) -> int:
        ent = self._series.get(_lkey(labels))
        return 0 if ent is None else ent[2]

    def sum(self, **labels) -> float:
        ent = self._series.get(_lkey(labels))
        return 0.0 if ent is None else ent[1]

    def series(self) -> list[tuple[dict, list, float, int]]:
        with _LOCK:
            return [
                (dict(k), list(e[0]), e[1], e[2])
                for k, e in self._series.items()
            ]


class Facts:
    """String-valued key → value table (run metadata, dispatch impls)."""

    kind = "facts"

    def __init__(self, name: str):
        self.name = name
        self._entries: dict[str, str] = {}

    def set(self, key: str, value) -> None:
        with _LOCK:
            self._entries[str(key)] = str(value)

    def get(self, key: str, default=None):
        return self._entries.get(str(key), default)

    def items(self) -> list[tuple[str, str]]:
        with _LOCK:
            return list(self._entries.items())

    def clear(self) -> None:
        with _LOCK:
            self._entries.clear()


class Registry:
    """Get-or-create home for every metric; names are validated against
    the frozen ``obs.names.METRICS`` vocabulary."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls):
        if name not in names.METRICS:
            raise ValueError(
                f"unknown metric name {name!r}: add it to "
                f"obs.names.METRICS (frozen vocabulary)"
            )
        with _LOCK:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def facts(self, name: str) -> Facts:
        return self._get(name, Facts)

    # -- persistence -------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-safe dump of every live series (schema-versioned)."""
        out = {
            "schema": SCHEMA,
            "bounds": list(BOUNDS),
            "counters": {},
            "gauges": {},
            "histograms": {},
            "facts": {},
        }
        with _LOCK:
            metrics = dict(self._metrics)
        for name, m in sorted(metrics.items()):
            if isinstance(m, Counter):
                out["counters"][name] = [
                    {"labels": lb, "value": v} for lb, v in m.series()
                ]
            elif isinstance(m, Gauge):
                out["gauges"][name] = [
                    {"labels": lb, "value": v} for lb, v in m.series()
                ]
            elif isinstance(m, Histogram):
                out["histograms"][name] = [
                    {"labels": lb, "buckets": b, "sum": s, "count": c}
                    for lb, b, s, c in m.series()
                ]
            elif isinstance(m, Facts):
                out["facts"][name] = dict(m.items())
        return out

    def write(self, run_dir) -> str:
        """Write ``metrics.json`` + ``metrics.prom`` under ``run_dir``."""
        run_dir = os.fspath(run_dir)
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, "metrics.json")
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
        with open(os.path.join(run_dir, "metrics.prom"), "w") as f:
            f.write(self.to_prometheus())
        return path

    def to_prometheus(self) -> str:
        """Prometheus text exposition of the current snapshot."""
        snap = self.snapshot()
        lines: list[str] = []

        def mangle(name: str) -> str:
            return "repro_" + name.replace(".", "_")

        def fmt_labels(lb: dict, extra: str = "") -> str:
            parts = [f'{k}="{v}"' for k, v in sorted(lb.items())]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        for name, series in sorted(snap["counters"].items()):
            n = mangle(name)
            lines.append(f"# TYPE {n} counter")
            for s in series:
                lines.append(f"{n}{fmt_labels(s['labels'])} {s['value']:g}")
        for name, series in sorted(snap["gauges"].items()):
            n = mangle(name)
            lines.append(f"# TYPE {n} gauge")
            for s in series:
                lines.append(f"{n}{fmt_labels(s['labels'])} {s['value']:g}")
        for name, series in sorted(snap["histograms"].items()):
            n = mangle(name)
            lines.append(f"# TYPE {n} histogram")
            for s in series:
                cum = 0
                for bound, c in zip(snap["bounds"], s["buckets"]):
                    cum += c
                    le = 'le="%g"' % bound
                    lines.append(
                        f"{n}_bucket{fmt_labels(s['labels'], le)} {cum}"
                    )
                cum += s["buckets"][-1]
                le_inf = 'le="+Inf"'
                lines.append(
                    f"{n}_bucket{fmt_labels(s['labels'], le_inf)} {cum}"
                )
                lines.append(
                    f"{n}_sum{fmt_labels(s['labels'])} {s['sum']:g}"
                )
                lines.append(
                    f"{n}_count{fmt_labels(s['labels'])} {s['count']}"
                )
        return "\n".join(lines) + "\n"

    @staticmethod
    def load(path) -> dict:
        """Read a ``metrics.json`` snapshot back (plain dict)."""
        with open(os.fspath(path)) as f:
            snap = json.load(f)
        if snap.get("schema") != SCHEMA:
            raise ValueError(
                f"metrics snapshot schema {snap.get('schema')!r} != {SCHEMA}"
            )
        return snap

    def reset(self) -> None:
        """Drop every metric (tests; never in production loops)."""
        with _LOCK:
            self._metrics.clear()


#: the process-global registry every instrumented layer records into
REGISTRY = Registry()


def count_dispatch(seconds: float, nbytes: float, **labels) -> None:
    """One kernel dispatch into ``dispatch.calls``,
    ``dispatch.seconds_total`` and ``dispatch.est_hbm_bytes_total``: one
    series key, three adds under one hold of the registry lock."""
    k = _lkey(labels)
    adds = ((REGISTRY.counter("dispatch.calls"), 1.0),
            (REGISTRY.counter("dispatch.seconds_total"), seconds),
            (REGISTRY.counter("dispatch.est_hbm_bytes_total"), nbytes))
    with _LOCK:
        for counter, v in adds:
            counter._series[k] = counter._series.get(k, 0.0) + v


class DispatchLog:
    """Dedup-counted dispatch log: ``key → (last value, hit count)``.

    The dispatch sites in ``kernels.ops`` note which impl served each
    shape key (``ATTN_DECODE_DISPATCH``) or why a shape fell back
    (``_QUANT_FALLBACKS``). In a long serving run the same key is hit
    once per decode step — like ``Health.record``, repeats must bump a
    counter, not grow state. Storage is bounded by the number of
    DISTINCT keys, and ``count(key)`` exposes how often each was served.
    The mapping surface (``in`` / ``[]`` / ``get`` / ``items`` /
    ``clear`` / truthiness) matches the plain dict these logs used to be.

    A log constructed with a ``name`` additionally mirrors every hit
    into the obs registry — a ``dispatch.log_calls`` counter series per
    (log, key) and the last value into the ``dispatch.<name>`` facts
    table — so serve's ``calls=N`` lines survive into ``metrics.json``.
    Unnamed logs (ad-hoc, tests) stay pure mappings.
    """

    def __init__(self, name: str | None = None) -> None:
        self._lock = threading.Lock()
        self._name = name
        self._entries: dict[str, list] = {}  # key -> [value, count]

    def __setitem__(self, key: str, value) -> None:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self._entries[key] = [value, 1]
            else:
                ent[0] = value  # e.g. a demoted rung's replacement impl
                ent[1] += 1
        if self._name is not None:
            REGISTRY.counter("dispatch.log_calls").inc(
                1.0, log=self._name, key=key
            )
            REGISTRY.facts("dispatch." + self._name).set(key, value)

    def __getitem__(self, key: str):
        return self._entries[key][0]

    def get(self, key: str, default=None):
        ent = self._entries.get(key)
        return default if ent is None else ent[0]

    def count(self, key: str) -> int:
        ent = self._entries.get(key)
        return 0 if ent is None else ent[1]

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self):
        return iter(list(self._entries))

    def keys(self):
        return list(self._entries)

    def items(self) -> list[tuple[str, object]]:
        with self._lock:
            return [(k, ent[0]) for k, ent in self._entries.items()]

    def counts(self) -> dict[str, int]:
        with self._lock:
            return {k: ent[1] for k, ent in self._entries.items()}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
        if self._name is not None:
            REGISTRY.counter("dispatch.log_calls")._drop("log", self._name)
            REGISTRY.facts("dispatch." + self._name).clear()
