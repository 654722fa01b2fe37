"""Calibration: per-site activation statistics into a ``QuantSpec``
(``repro.quant.calibrate``).

    calib = Calibration(percentile=99.9)
    with collecting(calib):
        model.prefill(params, batch)     # the layers observe their inputs
    spec = calib.spec(chains=CHAINS)     # site -> {"x_scale", "out_scale"?}

``models.layers.conv1d_bias_act`` calls :func:`observe` on its input
activation under its site name. While a ``collecting`` context is active,
the activation is copied to the host and the site's statistics, kept in
numpy, record the per-channel absmax and a bounded uniform reservoir of
|x|: every element draws a key from a generator seeded by
``(seed, crc32(site))`` and the reservoir keeps the ``reservoir`` smallest
keys seen (bottom-k, a uniform sample without replacement). The same
activations therefore draw the same reservoir as the reference, and the
site's scale, the ``percentile`` of the reservoir over 127 (+ 1e-12), agrees
to float rounding. Outside a ``collecting`` context ``observe`` costs one
check and copies nothing.

``spec(chains={producer: consumer})`` gives a producer whose consumer was
calibrated an ``out_scale``, the consumer's input scale: the producer conv
then requantizes in its epilogue (requant chaining).

:func:`counting_dequants` collects the sites whose quantized conv emitted
float output; a requant-chained pair of convs shows one such site.

``site_scale`` carries the reference's fault hook on the emitted scale
(``quant_scale_zero``, ``quant_scale_nan``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import zlib
from typing import Iterator

import numpy as np
import torch

from repro_torch import faults

# site name -> {"x_scale": float32 scalar tensor, "out_scale"?: the same}
QuantSpec = dict[str, dict[str, torch.Tensor]]


@dataclasses.dataclass
class _SiteStats:
    """Running per-channel absmax and a bounded uniform reservoir of |x|
    (bottom-k by random key)."""

    rng: np.random.Generator
    absmax: np.ndarray | None = None  # (C,) running per-channel max
    keys: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.float64))
    vals: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.float32))
    batches: int = 0

    def update(self, x: np.ndarray, reservoir: int) -> None:
        a = np.abs(x.astype(np.float32)).reshape(-1, x.shape[-1])
        cmax = a.max(axis=0)
        self.absmax = cmax if self.absmax is None else np.maximum(self.absmax, cmax)
        flat = a.reshape(-1)
        keys = np.concatenate([self.keys, self.rng.random(flat.size)])
        vals = np.concatenate([self.vals, flat])
        if keys.size > reservoir:
            keep = np.argpartition(keys, reservoir)[:reservoir]
            keys, vals = keys[keep], vals[keep]
        self.keys, self.vals = keys, vals
        self.batches += 1


class Calibration:
    """Collects activation statistics per conv site; emits a QuantSpec."""

    def __init__(self, percentile: float | None = 99.9, reservoir: int = 8192,
                 seed: int = 0):
        self.percentile = percentile
        self.reservoir = reservoir
        self.seed = seed
        self.stats: dict[str, _SiteStats] = {}

    def _site(self, site: str) -> _SiteStats:
        if site not in self.stats:
            # a per-site stream, so the order sites are observed in never
            # changes a site's draw
            self.stats[site] = _SiteStats(rng=np.random.default_rng(
                (self.seed, zlib.crc32(site.encode()))))
        return self.stats[site]

    def observe(self, site: str, x: torch.Tensor) -> None:
        if not x.is_floating_point():
            return  # int8 codes from a chained conv are not activations
        self._site(site).update(x.detach().float().cpu().numpy(),
                                self.reservoir)

    @property
    def seen(self) -> list[str]:
        return sorted(self.stats)

    def site_scale(self, site: str) -> torch.Tensor:
        """Per-tensor input scale of a site: the percentile (or the absmax)
        of |x| over every calibration batch, onto the int8 grid. The
        ``quant_scale_zero`` / ``quant_scale_nan`` faults corrupt it here,
        where a broken calibration run would."""
        st = self.stats[site]
        if self.percentile is None:
            hi = float(st.absmax.max())
        else:
            hi = max(float(np.percentile(st.vals, self.percentile)), 1e-8)
        return faults.corrupt_scale(
            site, torch.tensor(hi / 127.0 + 1e-12, dtype=torch.float32))

    def spec(self, chains: dict[str, str] | None = None) -> QuantSpec:
        """``chains`` maps producer site to consumer site: where both were
        calibrated, the producer's entry gains ``out_scale``, the
        consumer's ``x_scale``."""
        out = {s: {"x_scale": self.site_scale(s)} for s in self.seen}
        for producer, consumer in (chains or {}).items():
            if producer in out and consumer in out:
                out[producer]["out_scale"] = out[consumer]["x_scale"]
        return out


_ACTIVE: Calibration | None = None


@contextlib.contextmanager
def collecting(calib: Calibration) -> Iterator[Calibration]:
    """Route :func:`observe` calls into ``calib`` for the duration."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, calib
    try:
        yield calib
    finally:
        _ACTIVE = prev


def observe(site: str, x: torch.Tensor) -> None:
    """Instrumentation hook of the conv call sites (no-op unless
    collecting)."""
    if _ACTIVE is not None:
        _ACTIVE.observe(site, x)


def conv_site(kind: str, cin: int, cout: int, k) -> str:
    """Site name from the shape, where the caller gives none: identical
    layers share a scale."""
    return f"{kind}|Cin{cin}|Cout{cout}|K{k}"


_DEQUANT_LOG: list[str] | None = None


@contextlib.contextmanager
def counting_dequants() -> Iterator[list[str]]:
    """Collect the sites whose quantized conv emitted float output."""
    global _DEQUANT_LOG
    prev, _DEQUANT_LOG = _DEQUANT_LOG, []
    try:
        yield _DEQUANT_LOG
    finally:
        _DEQUANT_LOG = prev


def note_dequant(site: str) -> None:
    """Called where a quantized conv dequantizes to float."""
    if _DEQUANT_LOG is not None:
        _DEQUANT_LOG.append(site)
