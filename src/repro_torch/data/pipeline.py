"""Deterministic synthetic data pipeline.

A copy of ``repro.data.pipeline`` (numpy only), so the token stream is
bit-identical to the reference's. Properties a production loader needs,
reproduced here without external dependencies:

  * **step-indexed determinism** — ``batch_at(step)`` is a pure function of
    (seed, step); restart/resume replays the exact token stream;
  * **host sharding** — each host materializes only its slice
    (``host_id/num_hosts``);
  * **document packing** — synthetic "documents" (zipf-ish token runs with
    EOS boundaries) are packed into fixed-length rows; labels are inputs
    shifted left with −1 padding at document boundaries (tests assert the
    masking invariant);
  * **async prefetch** — a small background thread keeps ``prefetch``
    batches ahead (overlaps host data work with device compute).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np

EOS = 1
PAD_LABEL = -1


@dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    mean_doc_len: int = 512

    def __post_init__(self):
        assert self.global_batch % self.num_hosts == 0
        self.host_batch = self.global_batch // self.num_hosts

    def _row(self, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        """One packed row of documents + masked labels."""
        toks = np.empty(self.seq_len + 1, np.int32)
        labels_mask = np.ones(self.seq_len + 1, bool)
        i = 0
        while i < self.seq_len + 1:
            dlen = min(
                1 + rng.geometric(1.0 / self.mean_doc_len),
                self.seq_len + 1 - i,
            )
            # zipf-ish content tokens in [2, vocab)
            body = (
                rng.zipf(1.3, size=dlen).clip(1, self.vocab_size - 2) + 1
            ).astype(np.int32)
            toks[i : i + dlen] = body
            if i + dlen <= self.seq_len:
                toks[i + dlen - 1] = EOS
                labels_mask[i + dlen - 1] = False  # no loss across boundary
            i += dlen
        inputs = toks[:-1]
        labels = toks[1:].copy()
        labels[~labels_mask[1:]] = PAD_LABEL
        return inputs, labels

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of (seed, step, host) — restart-safe."""
        out_t = np.empty((self.host_batch, self.seq_len), np.int32)
        out_l = np.empty((self.host_batch, self.seq_len), np.int32)
        for r in range(self.host_batch):
            row_global = step * self.global_batch + self.host_id * self.host_batch + r
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, row_global])
            )
            out_t[r], out_l[r] = self._row(rng)
        return {"tokens": out_t, "labels": out_l}


def make_batch_iterator(
    data: SyntheticLMData, start_step: int = 0, prefetch: int = 2
) -> Iterator[tuple[int, dict[str, np.ndarray]]]:
    """Background-thread prefetching iterator yielding (step, batch)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put((step, data.batch_at(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
