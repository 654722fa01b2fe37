"""The port's card timer: CUDA events around batches of calls.

``card_ms`` is the one timer of the card's time per call: ``chip_smoke.py``
prints its timings with it, the scripts under ``scripts/`` time their
kernels with it, and the tuning layer (``kernels/autotune.py``) times its
candidates with it. ``call_ms`` is the same without filling the card's
queue first, so the host's time per call shows where the host is slower.
Both need a CUDA card.
"""
from __future__ import annotations

import statistics
import time

import torch


def call_ms(fn, batches: int = 20, inner: int = 10, warmup: int = 3) -> float:
    """Per-call time from CUDA events around ``inner`` back-to-back calls,
    median over ``batches``. Where the host queues calls more slowly than
    the card runs them, this is the host's time per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _sleep_cycles_per_ms() -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return 10_000_000 / a.elapsed_time(b)


def card_ms(fn, batches: int = 20, inner: int = 10, warmup: int = 3) -> float:
    """Card time per call from CUDA events: before each batch of ``inner``
    calls the card is kept busy (``torch.cuda._sleep``) for three times as
    long as the host takes to queue the batch, so the calls then run back
    to back with no wait for the host. Median over ``batches``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(3 * host_ms * _sleep_cycles_per_ms()) + 1
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)
