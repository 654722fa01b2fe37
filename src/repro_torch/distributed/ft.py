"""Fault-tolerance utilities: straggler watchdog, restart policy and the
per-host heartbeat (a copy of ``repro.distributed.ft``, its
``heartbeat_stale`` fault hook included).

  * ``StepWatchdog``: an EMA of step wall time; a step over
    ``threshold × EMA`` after warm-up is flagged and reported to a callback.
  * ``RestartPolicy``: a bounded exponential-backoff restart budget with
    deterministic seeded jitter.
  * ``beat``: an atomically written liveness timestamp per host, and
    ``stale_hosts``: the hosts whose last beat is older than a timeout.
"""
from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from repro_torch import faults


@dataclass
class StepWatchdog:
    threshold: float = 3.0  # × EMA before a step is "straggling"
    decay: float = 0.9
    warmup_steps: int = 5
    on_straggler: Callable[[int, float, float], None] | None = None
    ema: float | None = None
    seen: int = 0
    events: list = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step was flagged."""
        self.seen += 1
        flagged = False
        if self.ema is not None and self.seen > self.warmup_steps:
            if seconds > self.threshold * self.ema:
                flagged = True
                self.events.append((step, seconds, self.ema))
                if self.on_straggler:
                    self.on_straggler(step, seconds, self.ema)
        self.ema = (
            seconds
            if self.ema is None
            else self.decay * self.ema + (1 - self.decay) * seconds
        )
        return flagged


@dataclass
class RestartPolicy:
    """Bounded exponential-backoff restart budget with deterministic
    seeded jitter: each grant is scaled by ``1 + jitter · u``, u ~ U[0, 1)
    drawn from a generator seeded by ``(seed, restarts)``, so a replay
    gives the same delays and two hosts with other seeds decorrelate.
    ``jitter=0.0`` (the default) gives the plain doubling schedule."""

    max_restarts: int = 5
    base_backoff_s: float = 1.0
    max_backoff_s: float = 300.0
    jitter: float = 0.0
    seed: int = 0
    restarts: int = 0

    def next_backoff(self) -> float | None:
        """Seconds to wait before restarting, or None if budget exhausted."""
        if self.restarts >= self.max_restarts:
            return None
        delay = self.base_backoff_s * (2 ** self.restarts)
        if self.jitter > 0.0:
            u = random.Random(f"{self.seed}:{self.restarts}").random()
            delay *= 1.0 + self.jitter * u
        delay = min(delay, self.max_backoff_s)
        self.restarts += 1
        return delay

    def reset(self):
        self.restarts = 0


def heartbeat_file(run_dir: str | Path, host_id: int) -> Path:
    p = Path(run_dir) / "heartbeats" / f"host_{host_id}"
    p.parent.mkdir(parents=True, exist_ok=True)
    return p


def beat(run_dir: str | Path, host_id: int):
    """Write the liveness timestamp atomically (tmp + rename): a monitor
    reading mid-write sees the previous beat, never a torn file. The
    ``heartbeat_stale`` fault skips the write (a silently dead host)."""
    if faults.take("heartbeat_stale", f"host_{host_id}"):
        return
    p = heartbeat_file(run_dir, host_id)
    tmp = p.with_name(f".{p.name}.{os.getpid()}.tmp")
    tmp.write_text(str(time.time()))
    tmp.replace(p)


def stale_hosts(run_dir: str | Path, *, timeout_s: float) -> list[int]:
    """Host ids whose heartbeat is older than ``timeout_s``. An unparseable
    or empty heartbeat file counts as stale (a torn write or a dying host
    is what the monitor must flag, not crash on); files not named
    ``host_<int>`` (tmp files) are ignored."""
    hb_dir = Path(run_dir) / "heartbeats"
    if not hb_dir.exists():
        return []
    now = time.time()
    out = []
    for p in hb_dir.iterdir():
        if not p.name.startswith("host_"):
            continue
        try:
            host = int(p.name.split("_", 1)[1])
        except ValueError:
            continue
        try:
            stale = now - float(p.read_text()) > timeout_s
        except (OSError, ValueError):
            stale = True  # a torn or unreadable beat is not provably alive
        if stale:
            out.append(host)
    return sorted(out)
