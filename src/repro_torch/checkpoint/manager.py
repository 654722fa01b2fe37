"""Atomic, async checkpoints in the reference's on-disk format.

The format of ``repro.checkpoint.manager``, so either package restores the
other's checkpoints: a ``step_N/`` directory with one ``.npy`` per leaf of
the flattened state (keys joined by ".", the file named after the key) and
a ``manifest.json`` of per-leaf file, shape, dtype and byte count. A
tuple in the state, such as an int8 moment's (codes, scales) pair, is
flattened by position (``opt.m.<path>.0`` and ``.1``), as the reference's
manager flattens it.

  * **atomic**: written to ``step_N.tmp/`` and renamed to ``step_N/`` once
    every leaf and the manifest are on disk;
  * **async**: ``save(..., blocking=False)`` copies the state to host
    memory, then writes on a background thread; ``wait()`` joins it;
  * **retention**: the ``keep`` newest steps are kept;
  * **validation and recovery**: ``validate`` checks every leaf file
    against the manifest (npy header, shape, dtype, byte size) without
    reading the payload; ``quarantine`` moves a torn step to
    ``step_N.corrupt`` (``.corrupt.1``, ... if that exists);
    ``latest_valid_step`` quarantines newest-first until a step validates.

bfloat16 leaves: numpy has no bfloat16 without ``ml_dtypes``. The reference
writes them as 2-byte void (``V2``) arrays with ``"dtype": "bfloat16"`` in
the manifest; this module writes the same bits the same way and reads such
a leaf as int16, viewed as ``torch.bfloat16``.

Not ported: the reference's fault-injection hooks and its health record of
a quarantine (a line on stderr here) and the elastic re-shard of
``restore`` (one device).
"""
from __future__ import annotations

import json
import shutil
import sys
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

_BF16 = "bfloat16"


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}."))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(skeleton: Any, flat: dict[str, Any], prefix: str = ""):
    if isinstance(skeleton, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}.")
                for k, v in skeleton.items()}
    if isinstance(skeleton, (tuple, list)):
        return type(skeleton)(_unflatten_into(v, flat, f"{prefix}{i}.")
                              for i, v in enumerate(skeleton))
    return flat[prefix[:-1]]


def to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(host array to write, manifest dtype name): a copy, since training
    updates the state in place while an async save writes. bfloat16 goes
    out as its bits in a 2-byte void array, as the reference writes it."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), _BF16
    a = t.numpy()
    return a, str(a.dtype)


def from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A leaf read back: ``dtype`` is the manifest's name for it."""
    if dtype == _BF16:
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _step_of(p: Path) -> int | None:
    """Step number of a committed ``step_<N>`` dir; None for everything
    else (.tmp, .corrupt, stray non-numeric names)."""
    name = p.name
    if not (p.is_dir() and name.startswith("step_")):
        return None
    if name.endswith(".tmp") or ".corrupt" in name:
        return None
    try:
        return int(name.split("_", 1)[1])
    except ValueError:
        print(f"[ckpt] ignoring stray dir {p} (non-numeric step)",
              file=sys.stderr)
        return None


def latest_step(directory: str | Path) -> int | None:
    d = Path(directory)
    if not d.exists():
        return None
    steps = [s for p in d.iterdir() if (s := _step_of(p)) is not None]
    return max(steps) if steps else None


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: Any, *, blocking: bool = True,
             extra: dict | None = None):
        self.wait()
        host_flat = {k: to_numpy(v) for k, v in _flatten(state).items()}
        if blocking:
            self._write(step, host_flat, extra or {})
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_flat, extra or {}),
                daemon=True,
            )
            self._thread.start()

    def _write(self, step: int, host_flat: dict, extra: dict):
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "leaves": {}, **extra}
        for key, (arr, dtype) in host_flat.items():
            fn = key.replace("/", "_") + ".npy"
            np.save(tmp / fn, arr)
            manifest["leaves"][key] = {
                "file": fn, "shape": list(arr.shape), "dtype": dtype,
                "nbytes": (tmp / fn).stat().st_size,
            }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
        self._gc()

    def _gc(self):
        steps = sorted(
            s for p in self.dir.iterdir() if (s := _step_of(p)) is not None
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- validation + recovery -------------------------------------------------
    def validate(self, step: int) -> str | None:
        """None when the checkpoint is intact, else a reason string: the
        manifest parses and every leaf file exists with a readable npy
        header whose shape and dtype match the manifest, and the byte count
        where recorded. A bfloat16 leaf's header holds a 2-byte void."""
        d = self.dir / f"step_{step}"
        if not d.is_dir():
            return "missing"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
        except (OSError, ValueError) as e:
            return f"manifest unreadable: {e!r}"
        for key, meta in manifest.get("leaves", {}).items():
            f = d / meta["file"]
            try:
                size = f.stat().st_size
                if meta.get("nbytes") is not None and size != meta["nbytes"]:
                    return f"leaf {key}: {size}B != manifest {meta['nbytes']}B"
                arr = np.load(f, mmap_mode="r")
            except (OSError, ValueError) as e:
                return f"leaf {key}: unreadable ({e!r})"
            if list(arr.shape) != list(meta["shape"]):
                return f"leaf {key}: shape {list(arr.shape)} != {meta['shape']}"
            want = np.dtype("V2") if meta["dtype"] == _BF16 else meta["dtype"]
            if arr.dtype != want:
                return f"leaf {key}: dtype {arr.dtype} != {meta['dtype']}"
        return None

    def quarantine(self, step: int, reason: str = "") -> None:
        """Move a torn checkpoint to ``step_N.corrupt`` (kept for autopsy,
        invisible to ``latest_step`` and ``_gc``); an earlier quarantine of
        the same step is kept and this one takes ``step_N.corrupt.1``, ..."""
        d = self.dir / f"step_{step}"
        target = self.dir / f"step_{step}.corrupt"
        n = 0
        while target.exists():
            n += 1
            target = self.dir / f"step_{step}.corrupt.{n}"
        if d.exists():
            d.rename(target)
        print(f"[ckpt] quarantined step {step} to {target.name}: {reason}"[:240],
              file=sys.stderr)

    def latest_valid_step(self) -> int | None:
        """Newest step that passes ``validate``; invalid ones found on the
        way are quarantined."""
        while True:
            step = latest_step(self.dir)
            if step is None:
                return None
            reason = self.validate(step)
            if reason is None:
                return step
            self.quarantine(step, reason)

    # -- restore ----------------------------------------------------------------
    def restore(self, step: int, skeleton: Any, device=None) -> Any:
        """Load ``step`` into the structure of ``skeleton`` (a tree of
        tensors), each leaf on ``device`` (the skeleton leaf's device when
        None). Raises if a leaf's shape differs from the skeleton's."""
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {}
        for key, sk in _flatten(skeleton).items():
            meta = manifest["leaves"][key]
            t = from_numpy(np.load(d / meta["file"]), meta["dtype"])
            if tuple(t.shape) != tuple(sk.shape):
                raise ValueError(f"checkpoint leaf {key}: shape "
                                 f"{tuple(t.shape)}, expected {tuple(sk.shape)}")
            flat[key] = t.to(device if device is not None else sk.device)
        return _unflatten_into(skeleton, flat)

    def manifest(self, step: int) -> dict:
        return json.loads(
            (self.dir / f"step_{step}" / "manifest.json").read_text()
        )
