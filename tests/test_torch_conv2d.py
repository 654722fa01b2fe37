"""Sliding conv2d of the PyTorch port against the JAX reference, on the CPU.

The same numpy inputs go through the reference's 2-D sliding conv
(``repro.core.conv.conv2d_sliding`` + ``repro.kernels.ops.epilogue_unfused``,
``repro.kernels.ops.conv2d(backend="sliding")``, whose Pallas rung demotes
here to that twin, and the reference's ``core.conv.conv2d_xla`` for the
filters whose unrolled tap loop takes the reference long to compile) and
through the port's ``ops.conv2d`` (whose ``sliding`` and ``sliding_pallas``
backends run the CUDA kernel's plain version on a CPU tensor), the kernel's
``conv2d_sliding_plain`` and the ``core.conv`` twins. The filter sizes
cover the three regimes (custom 3 and 5, generic 7 and 14, compound 19 and
31); Cout 70 is not a multiple of any block. The kernel itself is held to
its plain version on the card by ``tests/test_torch_conv2d_card.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import conv as jconv  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sliding_conv2d as ts2  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402

# float32: the sums run in another order than the reference's (the
# tolerance of tests/test_kernels.py); bfloat16 compared in float32
TOL = dict(rtol=3e-4, atol=3e-4)
BTOL = dict(rtol=5e-2, atol=5e-2)
ACTS = ("none", "relu", "gelu", "silu")
# (k, stride): every regime, the strides (1,1), (2,2), (1,2) and (14,14)
SHAPES = [(3, (1, 1)), (5, (2, 2)), (7, (1, 2)), (14, (14, 14)),
          (19, (1, 1)), (31, (2, 2))]


def _inputs(seed, B=2, H=20, W=23, Cin=3, Cout=70, kh=3, kw=3):
    """x, w (scaled so every output is of order one) and bias."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, Cin)).astype(np.float32)
    w = (rng.normal(size=(kh, kw, Cin, Cout))
         / np.sqrt(kh * kw * Cin)).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    return x, w, b


@functools.partial(jax.jit, static_argnames=("stride", "twin"))
def _reference_conv(x, w, *, stride, twin):
    if twin:
        return jconv.conv2d_sliding(x, w, stride=stride, padding="VALID")
    return jconv.conv2d_xla(x, w, stride=stride, padding="VALID")


def _reference(x, w, b, *, stride, activation):
    """The reference's sliding twin (compiled once per shape; past k=14 its
    ``conv2d_xla``, ``lax.conv_general_dilated``, which the twins are
    validated against: the unrolled loop of k² taps takes minutes to
    compile there) + the unfused epilogue."""
    y = _reference_conv(x, w, stride=stride, twin=w.shape[0] <= 14)
    return np.asarray(jops.epilogue_unfused(
        y, None if b is None else jnp.asarray(b), activation))


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("k,stride", SHAPES)
def test_plain_kernel_matches_reference(k, stride, act):
    """The kernel's plain version on VALID input, bias on and off, every
    activation, against the reference."""
    with_bias = (k + ACTS.index(act)) % 2 == 0
    x, w, b = _inputs(k * 10 + ACTS.index(act), H=k + 9, W=k + 12,
                      Cin=5 if k < 14 else 3, kh=k, kw=k)
    b = b if with_bias else None
    want = _reference(x, w, b, stride=stride, activation=act)
    got = ts2.conv2d_sliding(*_t(x, w, b), stride=stride, activation=act)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = ts2.conv2d_sliding_plain(*_t(x, w, b), stride=stride,
                                     activation=act)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("k,stride", SHAPES[:4])
def test_ops_conv2d_matches_reference_ops(k, stride):
    """``ops.conv2d`` on ``sliding`` and ``sliding_pallas`` against the
    reference's ``ops.conv2d(backend="sliding")`` (its Pallas rung demotes
    to the jax twin here), bias and gelu fused."""
    x, w, b = _inputs(k + 100, H=k + 6, W=k + 8, Cin=4, kh=k, kw=k)
    want = np.asarray(jops.conv2d(x, w, stride=stride, bias=b,
                                  activation="gelu"))
    for backend in ("sliding", "sliding_pallas"):
        got = tops.conv2d(*_t(x, w), stride=stride, backend=backend,
                          bias=torch.from_numpy(b), activation="gelu")
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=backend)


@pytest.mark.parametrize("padding,dilation", [
    ("SAME", (1, 1)), ("VALID", (1, 1)), (((2, 1), (0, 3)), (1, 1)),
    ("SAME", (2, 1)), ("VALID", (1, 2)),
])
def test_ops_conv2d_padding_and_dilation_match_reference(padding, dilation):
    """SAME and explicit padding outside the kernel, and dilation through
    the ``core.conv`` twins, on every port backend, against the
    reference's ``ops.conv2d``."""
    x, w, b = _inputs(7, H=13, W=16, Cin=4, Cout=9, kh=3, kw=5)
    want = np.asarray(jops.conv2d(x, w, stride=(2, 1), padding=padding,
                                  dilation=dilation, bias=b,
                                  activation="silu"))
    for backend in tops.CONV2D_BACKENDS:
        got = tops.conv2d(*_t(x, w), stride=(2, 1), padding=padding,
                          dilation=dilation, backend=backend,
                          bias=torch.from_numpy(b), activation="silu")
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=backend)


@pytest.mark.parametrize("backend", ["sliding", "im2col_gemm", "xla"])
def test_core_conv2d_twins_match_reference(backend):
    """The port's ``core.conv.conv2d`` backends against the reference's own,
    SAME padding, stride (2, 1), dilation (1, 2)."""
    x, w, _ = _inputs(9, H=12, W=15, Cin=4, Cout=6, kh=3, kw=3)
    args = dict(stride=(2, 1), padding="SAME", dilation=(1, 2),
                backend=backend)
    want = np.asarray(jconv.conv2d(x, w, **args))
    got = tconv.conv2d(*_t(x, w), **args)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_xla_backend_is_f_conv2d():
    """``xla`` is ``torch.nn.functional.conv2d`` in NHWC / HWIO."""
    x, w, b = _inputs(12, H=11, W=12, Cin=4, Cout=6, kh=3, kw=2)
    got = tops.conv2d(*_t(x, w), stride=(2, 1), padding="SAME",
                      backend="xla")
    xt, wt = _t(x, w)
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(xt.permute(0, 3, 1, 2), (0, 1, 1, 1)),
        wt.permute(3, 2, 0, 1), stride=(2, 1)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("act", ["none", "gelu"])
@pytest.mark.parametrize("k,stride", [(3, (1, 1)), (14, (14, 14))])
def test_bf16_operands(k, stride, act):
    """bf16 x and w, float32 sums, output in bf16 (the reference's
    contract), compared in float32."""
    x, w, b = _inputs(k + 21, H=2 * k + 1, W=2 * k + 3, kh=k, kw=k)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    y = jconv.conv2d_sliding(xb, wb, stride=stride)
    want = np.asarray(jops.epilogue_unfused(y, jnp.asarray(b), act),
                      np.float32)
    got = tops.conv2d(torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(w).to(torch.bfloat16), stride=stride,
                      backend="sliding_pallas", bias=torch.from_numpy(b),
                      activation=act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BTOL)


@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5), (3, 5), (7, 7), (14, 14),
                                   (17, 17), (19, 19), (31, 31), (1, 18)])
def test_regime_rule_matches_reference(kh, kw):
    """The reference's rule (``conv2d_sliding_pallas``: custom for square
    3x3 and 5x5, else ``regime_for(kw)``)."""
    want = "custom" if (kh == kw and kh in (3, 5)) else jconv.regime_for(kw)
    assert ts2.resolve_regime(kh, kw, None) == want


def test_regime_and_tiles_do_not_change_the_result():
    x, w, b = _inputs(5, H=21, W=25, Cin=6, Cout=20, kh=5, kw=5)
    xt, wt, bt = _t(x, w, b)
    base = ts2.conv2d_sliding(xt, wt, bt, activation="relu")
    for kw in (dict(regime="generic"), dict(regime="compound"),
               dict(tile_h=4, tile_w=8), dict(cin_block=2, cout_block=8)):
        assert torch.equal(ts2.conv2d_sliding(xt, wt, bt, activation="relu",
                                              **kw), base), kw


@pytest.mark.parametrize("padding", ["SAME", "VALID", ((1, 2), (3, 0))])
@pytest.mark.parametrize("k", [1, 3, 14])
def test_padding_matches_reference(k, padding):
    assert (tconv._resolve_pad_2d(padding, k, k + 1, (1, 2))
            == jconv._resolve_pad_2d(padding, k, k + 1, (1, 2)))


def test_conv2d_key_and_dispatch_log_match_reference():
    args = (20, 336, 336, 3, 1152, 14, 14, 14, 14)
    for dtype in ("bfloat16", "float32"):
        for grad in (False, True):
            assert (tautotune.conv2d_key(*args, dtype, grad=grad)
                    == jautotune.conv2d_key(*args, dtype, grad=grad))
    tops.CONV2D_DISPATCH.clear()
    x, w, _ = _inputs(3, H=28, W=42, Cin=3, Cout=8, kh=14, kw=14)
    tops.conv2d(*_t(x, w), stride=(14, 14))
    key = jautotune.conv2d_key(2, 28, 42, 3, 8, 14, 14, 14, 14, "float32")
    assert tops.CONV2D_DISPATCH.items() == [(key, "plain")]


def test_conv2d_bias_act_observes_its_site_and_matches_ops():
    from repro_torch import quant

    x, w, b = _inputs(4, H=10, W=9, Cin=3, Cout=5, kh=3, kw=3)
    xt, wt, bt = _t(x, w, b)
    calib = quant.Calibration()
    with quant.collecting(calib):
        y = tL.conv2d_bias_act(xt, wt, bt, activation="gelu",
                               backend="sliding_pallas")
        tL.conv2d_bias_act(xt, wt, bt, activation="gelu", backend="sliding",
                           site="s")
    assert calib.seen == ["conv2d|Cin3|Cout5|K3x3", "s"]
    want = tops.conv2d(xt, wt, bias=bt, activation="gelu")
    assert torch.equal(y, want)
    for backend in ("sliding", "xla", "im2col_gemm"):
        got = tL.conv2d_bias_act(xt, wt, bt, activation="gelu",
                                 backend=backend)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_errors():
    x = torch.zeros(1, 8, 9, 3)
    w = torch.zeros(3, 3, 3, 4)
    with pytest.raises(ValueError, match="exceeds input"):
        ts2.conv2d_sliding(x, torch.zeros(9, 3, 3, 4))
    with pytest.raises(ValueError, match="exceeds input"):
        tops.conv2d(x, torch.zeros(3, 10, 3, 4))
    with pytest.raises(ValueError, match="do not form"):
        ts2.conv2d_sliding(x, torch.zeros(3, 3, 2, 4))
    with pytest.raises(ValueError, match="Cin mismatch"):
        tconv.conv2d_sliding(x, torch.zeros(3, 3, 2, 4))
    with pytest.raises(ValueError, match="unknown activation"):
        ts2.conv2d_sliding(x, w, activation="tanh")
    with pytest.raises(ValueError, match="unknown regime"):
        ts2.conv2d_sliding(x, w, regime="winograd")
    with pytest.raises(ValueError, match="tile_w"):
        ts2.conv2d_sliding(x, w, tile_w=0)
    with pytest.raises(ValueError, match="unknown conv backend"):
        tops.conv2d(x, w, backend="im2col_hbm")
    with pytest.raises(ValueError, match="no sliding_conv2d for device"):
        ts2.conv2d_sliding(x.to("meta"), w.to("meta"))
    for precision in ("w8a8", "w8a16"):  # the int8 kernel's plain version
        assert tops.conv2d(x, w, precision=precision).shape == (1, 6, 7, 4)
        with pytest.raises(NotImplementedError, match="inference only"):
            tops.conv2d(x.clone().requires_grad_(), w, precision=precision)
    y = tops.conv2d(x, w.clone().requires_grad_())  # the autograd Function
    assert type(y.grad_fn).__name__ == "Conv2dSlidingBackward"
    y, z = ts2.conv2d_sliding(x, w, save_preact=True)
    assert y.shape == z.shape == (1, 6, 7, 4)
    with torch.no_grad():  # no gradient asked for: served
        y = tops.conv2d(x, w.clone().requires_grad_())
        assert y.shape == (1, 6, 7, 4) and y.grad_fn is None


def test_cpu_calls_do_not_count_as_launches():
    before = ts2.conv2d_sliding.launches
    x, w, b = _inputs(2, H=9, W=9, Cin=2, Cout=3, kh=3, kw=3)
    ts2.conv2d_sliding(*_t(x, w, b))
    tops.conv2d(*_t(x, w))
    assert ts2.conv2d_sliding.launches == before
