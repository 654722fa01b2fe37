"""Tracing: spans + instants into a bounded ring buffer, exported as a
Chrome/Perfetto ``trace.json`` (the ``chrome://tracing`` JSON array
format: ``"X"`` complete events with microsecond ``ts``/``dur``, ``"i"``
instants).

Armed via ``REPRO_TRACE=1`` (read at import) or :func:`enable` /
``--trace``. The disabled path is the contract that matters:
:func:`span` does ONE module-global flag check and
returns a shared null context manager — no allocation, no clock read —
so instrumented call sites cost nothing when tracing is off.

Timestamps are ``perf_counter`` relative to a module-load epoch (the
monotonic clock Perfetto wants; wall-clock jumps cannot reorder the
timeline). The buffer is a ``deque(maxlen=...)``: a long serving run
keeps the most recent window instead of growing without bound.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

from repro_torch.obs import names

#: module-global arm flag — span()/instant() do a single check against it
TRACING: bool = os.environ.get("REPRO_TRACE", "") not in ("", "0")

#: ring capacity: ~200k events ≈ a few minutes of per-step serve spans
_MAXLEN = 200_000

_EPOCH = time.perf_counter()
_EVENTS: collections.deque = collections.deque(maxlen=_MAXLEN)
_LOCK = threading.Lock()


def enable(on: bool = True) -> None:
    """Arm (or disarm) tracing for the rest of the process."""
    global TRACING
    TRACING = bool(on)


def disable() -> None:
    enable(False)


def enabled() -> bool:
    return TRACING


def _check_name(name: str) -> None:
    if name not in names.SPANS:
        raise ValueError(
            f"unknown span name {name!r}: add it to obs.names.SPANS "
            f"(frozen vocabulary)"
        )


def _attr_values(attrs: dict) -> dict:
    """JSON-safe copy: scalars pass through, everything else stringifies."""
    return {
        k: v if isinstance(v, (str, int, float, bool)) or v is None
        else str(v)
        for k, v in attrs.items()
    }


class _NullSpan:
    """Shared no-op context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "_t0")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0

    def set(self, **attrs):
        """Attach attributes discovered mid-span (e.g. the winning rung)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        ev = {
            "name": self.name,
            "ph": "X",
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "ts": (self._t0 - _EPOCH) * 1e6,
            "dur": (t1 - self._t0) * 1e6,
        }
        if self.attrs:
            ev["args"] = _attr_values(self.attrs)
        with _LOCK:
            _EVENTS.append(ev)
        return False  # exceptions propagate; the span still records


def span(name: str, **attrs):
    """Context manager timing one named region; no-op when tracing is off.

        with obs.span("serve.prefill", arch=cfg.name):
            ...

    The name must come from the frozen ``obs.names.SPANS`` vocabulary.
    """
    if not TRACING:
        return _NULL
    _check_name(name)
    return _Span(name, attrs)


def traced(name: str, **attrs):
    """Decorator form of :func:`span` — the arm flag is checked at CALL
    time, so a function decorated while tracing was off still traces
    after :func:`enable`."""
    _check_name(name)

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not TRACING:
                return fn(*a, **kw)
            with _Span(name, dict(attrs)):
                return fn(*a, **kw)

        return wrapper

    return deco


def instant(name: str, **attrs) -> None:
    """Zero-duration marker on the timeline (health demotions, prunes)."""
    if not TRACING:
        return
    _check_name(name)
    ev = {
        "name": name,
        "ph": "i",
        "s": "p",  # process-scoped marker
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "ts": (time.perf_counter() - _EPOCH) * 1e6,
    }
    if attrs:
        ev["args"] = _attr_values(attrs)
    with _LOCK:
        _EVENTS.append(ev)


def events() -> list[dict]:
    """Snapshot of the ring buffer (oldest first)."""
    with _LOCK:
        return list(_EVENTS)


def clear() -> None:
    with _LOCK:
        _EVENTS.clear()


def export(path) -> str:
    """Write the buffer as Chrome/Perfetto trace JSON; returns the path."""
    doc = {"traceEvents": events(), "displayTimeUnit": "ms"}
    path = os.fspath(path)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
