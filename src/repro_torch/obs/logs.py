"""Leveled status logging: ``obs.info("serve", msg)`` → ``[serve] msg``.

Replaces the bare ``print`` soup in serve/train with one leveled sink.
The output format is deliberately IDENTICAL to the old prints
(``[{tag}] {msg}`` on stdout, flushed) — CI's chaos/serve jobs grep the
raw log lines, so routing through obs must be invisible to them.

``REPRO_LOG=debug|info|warn`` sets the threshold (default ``info``);
:func:`set_level` overrides it at runtime.
"""
from __future__ import annotations

import os
import sys

LEVELS = {"debug": 10, "info": 20, "warn": 30}

_threshold = LEVELS.get(os.environ.get("REPRO_LOG", "info").lower(), 20)


def set_level(level: str) -> None:
    """Set the log threshold: "debug", "info", or "warn"."""
    global _threshold
    try:
        _threshold = LEVELS[level.lower()]
    except KeyError:
        raise ValueError(
            f"unknown log level {level!r}: one of {sorted(LEVELS)}"
        ) from None


def level() -> str:
    return {v: k for k, v in LEVELS.items()}[_threshold]


def log(level: str, tag: str, msg: str) -> None:
    """Emit ``[{tag}] {msg}`` to stdout if ``level`` clears the threshold."""
    if LEVELS.get(level, 20) < _threshold:
        return
    print(f"[{tag}] {msg}", flush=True)


def debug(tag: str, msg: str) -> None:
    log("debug", tag, msg)


def info(tag: str, msg: str) -> None:
    log("info", tag, msg)


def warn(tag: str, msg: str) -> None:
    log("warn", tag, msg)


# stderr variant for lines that must not pollute a machine-read stdout
def warn_err(tag: str, msg: str) -> None:
    if LEVELS["warn"] >= _threshold:
        print(f"[{tag}] {msg}", file=sys.stderr, flush=True)
