"""repro_torch.quant: int8 post-training quantization of the sliding-conv
path (``repro.quant``).

  * ``qconv``: quantizers, ``QuantizedWeight`` and the plain quantized
    sliding conv1d and conv2d and depthwise conv1d (the exact int32
    oracles and the float32 paths), and the int8 im2col conv2d baseline;
  * ``calibrate``: activation statistics per conv site into a ``QuantSpec``;
  * ``apply``: int8 weight leaves swapped into model params.

The int8 kernels live with the other kernels
(``repro_torch.kernels.sliding_conv_quant``) and are reached through
``repro_torch.kernels.ops.conv1d(precision=...)``,
``ops.conv2d(precision=...)`` and ``ops.conv1d_depthwise(precision=...)``.
"""
from repro_torch.quant.apply import (
    CHAINS,
    WEIGHT_ONLY_KEYS,
    quantize_depthwise_weight,
    quantize_params,
    quantized_site_count,
)
from repro_torch.quant.calibrate import (
    Calibration,
    QuantSpec,
    collecting,
    counting_dequants,
    observe,
)
from repro_torch.quant.qconv import (
    QuantizedWeight,
    act_scale,
    conv1d_depthwise_q,
    conv1d_q,
    conv2d_q,
    conv2d_q_im2col,
    quantize_act,
    quantize_weight,
)

__all__ = [
    "CHAINS",
    "Calibration",
    "QuantSpec",
    "QuantizedWeight",
    "WEIGHT_ONLY_KEYS",
    "act_scale",
    "collecting",
    "conv1d_depthwise_q",
    "conv1d_q",
    "conv2d_q",
    "conv2d_q_im2col",
    "counting_dequants",
    "observe",
    "quantize_act",
    "quantize_depthwise_weight",
    "quantize_params",
    "quantize_weight",
    "quantized_site_count",
]
