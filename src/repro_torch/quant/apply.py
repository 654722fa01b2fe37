"""Swap int8 ``QuantizedWeight`` leaves into model params
(``repro.quant.apply``, conv sites).

``quantize_params`` replaces the conv weights the quantized sliding kernel
consumes (whisper's ``frontend/conv{1,2}_w``, sites ``whisper/conv1`` and
``whisper/conv2``) with int8 leaves, each carrying its site's calibrated
input scale and, for a requant-chained producer, its ``out_scale``:

    calib = Calibration()
    with collecting(calib):
        model.prefill(params, batch)
    qparams = quantize_params(params, spec=calib.spec(chains=CHAINS))
    # run with cfg.replace(conv_precision="w8a8")

Depthwise conv weights (``WEIGHT_ONLY_KEYS``: mamba's ``conv_w``, (…, K, C)
with jamba's periods stacked ahead) become int8 leaves with a per-channel
scale over the tap axis, kept as (…, 1, C); their site, named from the
shape (``conv1d_dw|Cin..|Cout..|K..``), gives the leaf its ``x_scale`` where
it was calibrated. They serve w8a8 through the int8 depthwise kernel when
the config asks for it, and dequantize as weights otherwise.

An unusable calibrated scale (non-finite or not positive) is screened out
here, with a health event: a bad input scale keeps the weight float (a
quantized call site then quantizes it at call time, with a dynamic
activation scale), a bad ``out_scale`` breaks the chain (the producer
dequantizes to float instead); a depthwise leaf with a bad input scale is
quantized all the same and takes a dynamic scale at call time.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.health import HEALTH
from repro_torch.quant.calibrate import QuantSpec, conv_site
from repro_torch.quant.qconv import QuantizedWeight, quantize_weight

# params-tree key -> calibration site of the fully quantized conv sites
SITE_FOR_KEY = {
    "conv1_w": "whisper/conv1",
    "conv2_w": "whisper/conv2",
}
# producer site -> consumer site: the producer's output feeds the consumer
# (directly, or through a max pool, which commutes with a per-tensor int8
# grid), so the producer can requantize in its epilogue onto the consumer's
# input grid. Entries take effect only when both sites were calibrated.
CHAINS = {
    "whisper/conv1": "whisper/conv2",
    "edge/c1": "edge/c2",
    "edge/c2": "edge/c3",
    "llava/patch_embed": "llava/projector",
}
# depthwise conv weights: int8 with per-channel scales over the tap axis
WEIGHT_ONLY_KEYS = ("conv_w",)


def quantize_depthwise_weight(w: torch.Tensor, x_scale=None) -> QuantizedWeight:
    """int8 codes of a depthwise (…, K, C) weight: the scale is per channel
    over the tap axis, kept as (…, 1, C) so ``q * scale`` broadcasts under
    any stacking ahead of K."""
    wf = w.float()
    s = wf.abs().amax(dim=-2, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return QuantizedWeight(q, s, x_scale)


def scale_reason(s) -> str | None:
    """Reason code when a scale is unusable (non-finite or not positive),
    else None. Reads the scale on the host (a synchronise for a card
    tensor)."""
    if s is None:
        return None
    a = np.asarray(torch.as_tensor(s).detach().float().cpu(), dtype=np.float64)
    if not np.isfinite(a).all():
        return "quant_scale_nan"
    if (a <= 0.0).any():
        return "quant_scale_zero"
    return None


def quantize_params(params: Any, spec: QuantSpec | None = None) -> Any:
    """A copy of ``params`` with the known conv weights quantized, each
    site's ``x_scale`` (and ``out_scale``) from ``spec`` folded into its
    leaf; a site missing from ``spec`` quantizes its input dynamically at
    call time. w8a8 or w8a16 is decided at the call sites (the config's
    ``conv_precision``): this function only prepares the int8 leaves."""
    spec = spec or {}

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key in SITE_FOR_KEY:
                site = SITE_FOR_KEY[key]
                entry = spec.get(site, {})
                x_scale, out_scale = entry.get("x_scale"), entry.get("out_scale")
                bad = scale_reason(x_scale)
                if bad is not None:
                    HEALTH.record(site, bad, "fallback:fp")
                    out[key] = val
                    continue
                bad_out = scale_reason(out_scale)
                if bad_out is not None:
                    HEALTH.record(site, bad_out, "fallback:no_requant")
                    out_scale = None
                dev = val.device
                out[key] = quantize_weight(
                    val, None if x_scale is None else x_scale.to(dev),
                    None if out_scale is None else out_scale.to(dev))
            elif key in WEIGHT_ONLY_KEYS:
                c, k = val.shape[-1], val.shape[-2]
                dw_site = conv_site("conv1d_dw", c, c, k)
                x_scale = spec.get(dw_site, {}).get("x_scale")
                bad = scale_reason(x_scale)
                if bad is not None:
                    HEALTH.record(dw_site, bad, "fallback:dynamic_scale")
                    x_scale = None
                if x_scale is not None:
                    # one scale per stacked layer, as every leaf of the
                    # stack has the layer axis
                    x_scale = x_scale.to(val.device).expand(val.shape[:-2])
                out[key] = quantize_depthwise_weight(val, x_scale)
            else:
                out[key] = val
        return out

    return walk(params)


def quantized_site_count(params: Any) -> int:
    """Number of QuantizedWeight leaves in a params tree."""
    if isinstance(params, QuantizedWeight):
        return 1
    if isinstance(params, dict):
        return sum(quantized_site_count(v) for v in params.values())
    return 0
