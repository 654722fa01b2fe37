"""Deterministic, seedable fault injection for the robustness layer.

The reference's ``repro.faults``, with the same environment variable, fault
kinds, spec grammar and sites, so one ``REPRO_FAULTS=...`` string drives
both packages. Production code calls small hooks at its failure points
(``maybe_fail``, ``sleep_point``, ``corrupt_array``, ``corrupt_rows``,
``corrupt_scale``, ``take``, ``guest_trap``); each is a no-op unless an
injection is armed, programmatically::

    with faults.inject("pallas_compile", site="conv1d", times=1):
        ops.conv1d(x, w)          # the cuda rung raises; the ladder demotes

or through the environment, for a whole process::

    REPRO_FAULTS=pallas_compile                      # every site
    REPRO_FAULTS=pallas_compile:conv1d,quant_scale_zero:whisper/conv1
    REPRO_FAULTS=slow_step*2                         # fire at most twice

Spec grammar: ``kind[:site][*times]`` joined by commas.

  ====================  =====================================================
  kind                  hook / effect
  ====================  =====================================================
  pallas_compile        ``ops._ladder``, cuda rung: raises ``FaultError``
                        before the launch (the ladder demotes in place)
  pallas_runtime        ``guest_trap``, cuda rung: records a ``Trip`` after
                        the launch; ``raise_pending`` raises it at the next
                        synchronise, where serve's and train's catch layers
                        demote the rung and re-run
  jax_runtime           ``ops._ladder``, plain rung: raises ``FaultError``
  nan_activations       ``corrupt_array``: poisons a tensor with NaN;
                        ``corrupt_rows``: poisons one batch row (slot);
                        ``guest_trap``: a kernel site emitting NaN
  quant_scale_zero      ``corrupt_scale``: calibration emits a 0.0 scale
  quant_scale_nan       ``corrupt_scale``: calibration emits a NaN scale
  autotune_corrupt      ``autotune._load``: treats the cache file as corrupt
  ckpt_corrupt          ``CheckpointManager._write``: truncates a leaf
  ckpt_write_stall      ``CheckpointManager._write``: sleeps between leaves
  heartbeat_stale       ``ft.beat``: skips the heartbeat write (dead host)
  slow_step             train and serve loops: sleeps ``delay_s``
  ====================  =====================================================

The kinds keep the reference's names: ``pallas_*`` fire on the port's
``cuda`` rung (the hand-written kernel) and ``jax_runtime`` on its ``plain``
rung (``RUNG_KINDS``, ``RUNTIME_RUNG_KINDS``).

The runtime trap is eager. A real device fault in eager PyTorch surfaces
at the next synchronise, not at the launch, and ``guest_trap`` models that:
a runtime kind or ``nan_activations`` firing at a kernel site records a
``Trip`` (site, rung, dispatch key, kind) after the launch and returns.
With ``REPRO_RUNTIME_SENTINEL`` set it also ORs ``~isfinite(out).all()``
into a device-side flag per (site, rung, key), with no host read per
dispatch. ``raise_pending(device)``, called after serve's and train's
synchronise points, reads those flags once and raises
``FaultError(kind, site)`` for a pending trip; the catch layer takes the
trip with ``consume_trip``. A trip the sentinel found is marked
``injected=False``: nothing was armed, a rung really emitted a non-finite
value, and the catch layers fail the request or step on it instead of
demoting the rung.

Determinism: an injection fires on every matching call (up to ``times``)
unless given a probability ``p < 1``; then its draws come from a numpy
generator seeded with ``seed``, so the fire/skip sequence is a function of
the call order alone. Sites match hierarchically: an injection for
``site="conv1d"`` also hits ``"conv1d.w8a8"``; ``site=None`` hits every
site.

Disarmed cost: ``ARMED`` is one module-level boolean, set by ``inject``,
``reload_env``, ``reset`` and the sentinel variable; every hook reads it
first and returns, with no lock and no environment read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Iterator

import numpy as np
import torch

ENV_VAR = "REPRO_FAULTS"
#: arm the non-finite output sentinel at every ladder site
SENTINEL_ENV = "REPRO_RUNTIME_SENTINEL"


class FaultError(RuntimeError):
    """Raised by an armed hook; carries the fault kind and the site.
    ``injected`` False: raised for a trip of the sentinel."""

    def __init__(self, kind: str, site: str | None, injected: bool = True):
        super().__init__(f"injected fault {kind!r} at site {site!r}"
                         if injected else
                         f"non-finite output at site {site!r} (sentinel)")
        self.kind = kind
        self.site = site


@dataclasses.dataclass
class Injection:
    kind: str
    site: str | None = None  # None: every site
    times: int | None = None  # None: unlimited
    p: float = 1.0  # fire probability per matching call
    seed: int = 0
    delay_s: float = 0.05  # for the sleep hooks (slow_step, ckpt_write_stall)
    fired: int = 0
    _rng: np.random.Generator | None = None

    def matches(self, site: str | None) -> bool:
        if self.site is None or site is None:
            return True
        return site == self.site or site.startswith(self.site + ".")

    def take(self) -> bool:
        """Consume one firing opportunity; True if the fault fires now."""
        if self.times is not None and self.fired >= self.times:
            return False
        if self.p < 1.0:
            if self._rng is None:
                self._rng = np.random.default_rng(self.seed)
            if self._rng.random() >= self.p:
                return False
        self.fired += 1
        return True


@dataclasses.dataclass(frozen=True)
class Trip:
    """One runtime trap firing: the (site, rung) the failure maps back to,
    the dispatch key and the fault kind; ``injected`` is False for a trip
    of the sentinel (a real non-finite output)."""

    site: str
    rung: str
    key: str | None
    kind: str
    injected: bool = True


_LOCK = threading.Lock()
_ACTIVE: list[Injection] = []
_TRIP: list[Trip] = []  # single-slot mailbox
# (site, rung, key) -> device-side bool: some output there was non-finite
_FLAGS: dict[tuple, torch.Tensor] = {}
_SENTINEL = False
#: anything armed: an injection, or the sentinel (the hooks' one check)
ARMED = False


def _parse_env(spec: str) -> list[Injection]:
    """``kind[:site][*times]`` entries joined by commas."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        times = None
        if "*" in entry:
            entry, _, n = entry.rpartition("*")
            times = int(n)
        kind, _, site = entry.partition(":")
        out.append(Injection(kind=kind, site=site or None, times=times))
    return out


def _rearm() -> None:
    """Recompute ``ARMED``; the caller holds ``_LOCK``."""
    global ARMED
    ARMED = bool(_ACTIVE) or _SENTINEL


def _read_sentinel() -> None:
    global _SENTINEL
    _SENTINEL = os.environ.get(SENTINEL_ENV, "") not in ("", "0")


def reload_env() -> None:
    """Re-read ``REPRO_FAULTS`` and ``REPRO_RUNTIME_SENTINEL``: the
    environment's injections replace every armed one."""
    with _LOCK:
        _ACTIVE.clear()
        _ACTIVE.extend(_parse_env(os.environ.get(ENV_VAR, "")))
        _read_sentinel()
        _rearm()


def reset() -> None:
    """Disarm every injection, the environment's too, and drop pending
    trips and sentinel flags. The sentinel follows its variable."""
    with _LOCK:
        _ACTIVE.clear()
        _TRIP.clear()
        _FLAGS.clear()
        _read_sentinel()
        _rearm()


def sentinel_on() -> bool:
    return _SENTINEL


def active(kind: str, site: str | None = None) -> Injection | None:
    """The first armed injection matching (kind, site), else None."""
    if not ARMED:
        return None
    with _LOCK:
        for inj in _ACTIVE:
            if inj.kind == kind and inj.matches(site):
                return inj
    return None


def take(kind: str, site: str | None = None) -> bool:
    """True exactly when an armed matching injection fires (and uses one of
    its ``times``)."""
    inj = active(kind, site)
    if inj is None:
        return False
    with _LOCK:
        return inj.take()


def maybe_fail(kind: str, site: str | None = None) -> None:
    """Raise ``FaultError(kind, site)`` when armed."""
    if ARMED and take(kind, site):
        raise FaultError(kind, site)


#: rung -> the fault kinds that fire at the ladder, before the rung runs
RUNG_KINDS = {"cuda": ("pallas_compile",), "plain": ("jax_runtime",)}
#: rung -> the fault kinds the guest trap fires after the rung ran
RUNTIME_RUNG_KINDS = {"cuda": ("pallas_runtime",)}


def maybe_fail_rung(rung: str, site: str) -> None:
    """Ladder hook: check every fault kind registered for this rung."""
    if ARMED:
        for kind in RUNG_KINDS.get(rung, ()):
            maybe_fail(kind, site)


def _record_trip(trip: Trip) -> None:
    with _LOCK:
        _TRIP[:] = [trip]


def consume_trip(site: str | None = None) -> Trip | None:
    """Pop the pending trip (the catch layer's attribution read), else None.
    With ``site`` given, pops only a trip recorded for that site."""
    with _LOCK:
        if not _TRIP or (site is not None and _TRIP[0].site != site):
            return None
        return _TRIP.pop()


def guest_trap(site: str, rung: str, key: str | None, out) -> None:
    """The runtime hooks after a rung served ``site``: an armed runtime kind
    of the rung, or ``nan_activations`` at the site, fires and records a
    ``Trip``; with the sentinel on, ``out``'s floating tensors are checked
    on the device into the flag of (site, rung, key). Nothing is read back
    here: ``raise_pending`` does that at the caller's next synchronise."""
    if not ARMED:
        return
    for kind in RUNTIME_RUNG_KINDS.get(rung, ()) + ("nan_activations",):
        if take(kind, site):
            _record_trip(Trip(site, rung, key, kind))
            return
    if not _SENTINEL:
        return
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    for t in leaves:
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            bad = ~torch.isfinite(t.detach()).all()
            k = (site, rung, key)
            with _LOCK:
                prev = _FLAGS.get(k)
                _FLAGS[k] = bad if prev is None else prev | bad


def raise_pending(device=None) -> None:
    """The trap's surfacing point, called after a synchronise: read the
    sentinel flags (those on ``device``, or all) in one transfer a device,
    record a trip (``injected=False``) for the first non-finite site, and
    raise ``FaultError(kind, site)`` while a trip is pending. The trip
    stays in the mailbox for the catch layer's ``consume_trip``."""
    if not ARMED:
        return
    if _FLAGS:
        dev = None if device is None else torch.device(device)
        with _LOCK:
            keys = [k for k, f in _FLAGS.items()
                    if dev is None or f.device.type == dev.type]
            flags = [_FLAGS.pop(k) for k in keys]
        by_dev: dict = {}
        for k, f in zip(keys, flags):
            by_dev.setdefault(f.device, []).append((k, f))
        for pairs in by_dev.values():
            bad = torch.stack([f for _, f in pairs]).tolist()
            hit = next((k for (k, _), b in zip(pairs, bad) if b), None)
            if hit is not None and not _TRIP:
                _record_trip(Trip(*hit, "nan_activations", injected=False))
    with _LOCK:
        trip = _TRIP[0] if _TRIP else None
    if trip is not None:
        raise FaultError(trip.kind, trip.site, trip.injected)


def corrupt_rows(kind: str, site_prefix: str, x: torch.Tensor) -> torch.Tensor:
    """Per-row (slot) poison: an injection armed at ``{site_prefix}.{i}``
    NaNs batch row ``i`` of ``x``; armed at ``site_prefix`` itself it
    poisons every row. The serve decode loop calls this on the logits."""
    if not ARMED:
        return x
    rows = [i for i in range(x.shape[0]) if take(kind, f"{site_prefix}.{i}")]
    if not rows:
        return x
    x = x.clone()
    x[rows] = float("nan")
    return x


def sleep_point(kind: str, site: str | None = None) -> float:
    """Sleep ``delay_s`` when armed (straggler / stalled write); returns the
    seconds slept."""
    inj = active(kind, site)
    if inj is None:
        return 0.0
    with _LOCK:
        fired = inj.take()
    if not fired:
        return 0.0
    time.sleep(inj.delay_s)
    return inj.delay_s


def corrupt_array(kind: str, site: str | None,
                  x: torch.Tensor) -> torch.Tensor:
    """``x`` filled with NaN when armed (``nan_activations``)."""
    if ARMED and take(kind, site):
        return torch.full_like(x, float("nan"))
    return x


def corrupt_scale(site: str, scale: torch.Tensor) -> torch.Tensor:
    """Calibration hook: a site's emitted activation scale replaced by 0.0
    or NaN when ``quant_scale_zero`` / ``quant_scale_nan`` is armed."""
    if not ARMED:
        return scale
    if take("quant_scale_zero", site):
        return torch.zeros_like(scale)
    if take("quant_scale_nan", site):
        return torch.full_like(scale, float("nan"))
    return scale


def truncate_file(path, keep_bytes: int = 16) -> None:
    """Torn-write simulator: chop a file to ``keep_bytes``."""
    with open(path, "rb") as f:
        data = f.read()[:keep_bytes]
    with open(path, "wb") as f:
        f.write(data)


@contextlib.contextmanager
def inject(kind: str, site: str | None = None, *, times: int | None = None,
           p: float = 1.0, seed: int = 0,
           delay_s: float = 0.05) -> Iterator[Injection]:
    """Arm one injection for the duration of the block (the environment's
    stay armed for the whole process)."""
    inj = Injection(kind=kind, site=site, times=times, p=p, seed=seed,
                    delay_s=delay_s)
    with _LOCK:
        _ACTIVE.append(inj)
        _rearm()
    try:
        yield inj
    finally:
        with _LOCK:
            if inj in _ACTIVE:
                _ACTIVE.remove(inj)
            _rearm()


reload_env()
