"""The port's depthwise conv1d, float and int8, and the float conv's
backward, against the JAX reference on the CPU.

The same numpy inputs go through the reference's plain depthwise conv
(``core.conv.conv1d_depthwise_sliding``, the rung that serves where its
Pallas kernel cannot trace) with the unfused epilogue
(``ops.epilogue_unfused``), and through the port's kernel wrapper, which
runs its plain version on a CPU tensor: float32 outputs within ``TOL``
(``tests/test_kernels.py``). The int8 depthwise conv (``qconv.
conv1d_depthwise_q``, exact int32 sums, the oracle of the int8 kernel)
gives the same float32 outputs within ``TIGHT`` (``tests/test_quant.py``)
and the same requantized codes, but for a difference of one where the
reference's ``y / out_scale`` lies within float rounding of a
half-integer (PyTorch's and XLA's silu and gelu differ in the last bit).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import conv as jconv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.quant import apply as japply  # noqa: E402
from repro.quant import qconv as jq  # noqa: E402
from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sliding_conv1d as tsc  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as tsb  # noqa: E402
from repro_torch.kernels import sliding_conv_quant as tsq  # noqa: E402
from repro_torch.quant import apply as tapply  # noqa: E402
from repro_torch.quant import qconv as tq  # noqa: E402

TOL = dict(rtol=3e-4, atol=3e-4)  # tests/test_kernels.py
TIGHT = dict(rtol=1e-5, atol=1e-5)  # tests/test_quant.py
TIE = 1e-3  # code units: how near a half-integer float rounding can move
ACTS = ("none", "relu", "gelu", "silu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, B, L, C, K, with_bias=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    w = (rng.normal(size=(K, C)) / np.sqrt(K)).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32) if with_bias else None
    return x, w, b


def _codes_equal(got, want, pre):
    """int8 codes equal, except a difference of one where ``pre`` (the
    reference's float ``y / out_scale``) lies within TIE of a
    half-integer."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = np.abs(got - want)
    assert diff.max(initial=0) <= 1, f"codes differ by {diff.max()}"
    off = diff > 0
    near_tie = np.abs(np.abs(pre - np.floor(pre)) - 0.5) < TIE
    assert (near_tie | ~off).all(), (
        f"{int((off & ~near_tie).sum())} codes differ away from a tie")
    return int(off.sum())


# -- float -------------------------------------------------------------------

@pytest.mark.parametrize("K,stride,padding", [
    (4, 1, "CAUSAL"), (2, 1, "CAUSAL"), (3, 2, "SAME"), (5, 1, "VALID"),
    (4, 3, (2, 1)), (1, 1, "VALID"), (7, 2, "CAUSAL"),
])
def test_depthwise_sliding_matches_reference(K, stride, padding):
    x, w, _ = _inputs(K * 10 + stride, 2, 37, 13, K)
    want = np.asarray(jconv.conv1d_depthwise_sliding(
        jnp.asarray(x), jnp.asarray(w), padding=padding, stride=stride))
    got = tconv.conv1d_depthwise_sliding(_t(x), _t(w), padding=padding,
                                         stride=stride)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("K,stride,padding,activation,with_bias",
                         [(K, s, p, a, bias) for (K, s, p), a, bias in
                          itertools.product(
                              [(4, 1, "CAUSAL"), (3, 2, "SAME"),
                               (5, 1, (1, 3)), (2, 3, "VALID")],
                              ACTS, (True, False))])
def test_depthwise_kernel_plain_matches_reference(K, stride, padding,
                                                  activation, with_bias):
    """The port's fused conv -> bias -> activation (``ops.conv1d_depthwise``
    on a CPU tensor: padding, then the kernel's plain version) against the
    reference's plain conv with the unfused epilogue."""
    x, w, b = _inputs(K + stride, 2, 41, 24, K, with_bias)
    jx = jconv.conv1d_depthwise_sliding(jnp.asarray(x), jnp.asarray(w),
                                        padding=padding, stride=stride)
    want = np.asarray(jops.epilogue_unfused(
        jx, None if b is None else jnp.asarray(b), activation))
    got = tops.conv1d_depthwise(_t(x), _t(w), stride=stride, padding=padding,
                                bias=None if b is None else _t(b),
                                activation=activation)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_depthwise_plain_bf16_rounds_once():
    """bfloat16 operands: products, sums, bias and activation in float32,
    then one rounding to bfloat16, as the kernel does."""
    x, w, b = _inputs(3, 2, 30, 16, 4)
    xb, wb = _t(x).bfloat16(), _t(w).bfloat16()
    got = tsc.conv1d_depthwise_plain(xb, wb, _t(b), activation="silu")
    assert got.dtype == torch.bfloat16
    exact = tsc.conv1d_depthwise_plain(xb.float(), wb.float(), _t(b),
                                       activation="silu")
    np.testing.assert_array_equal(got.float().numpy(),
                                  exact.bfloat16().float().numpy())


def test_depthwise_dispatch_logs_the_reference_key():
    tops.CONV1D_DW_DISPATCH.clear()
    x, w, b = _inputs(0, 2, 16, 8, 4)
    tops.conv1d_depthwise(_t(x), _t(w), bias=_t(b), activation="silu")
    assert tops.CONV1D_DW_DISPATCH.items() == [
        ("conv1ddw|B2|L19|C8|K4|s1|float32", "plain")]
    from repro.kernels import autotune as jautotune

    assert tops.CONV1D_DW_DISPATCH.items()[0][0] == jautotune.conv1d_dw_key(
        2, 19, 8, 4, 1, "float32")


def test_depthwise_checks_and_no_backward():
    """The wrappers' checks; a call whose inputs need a gradient goes
    through ``Conv1dDepthwise`` (the no-backward refusal this test was named
    for is gone); the int8 path stays inference only."""
    x, w, b = _inputs(0, 2, 8, 6, 4)
    with pytest.raises(ValueError, match="do not form"):
        tsc.conv1d_depthwise(_t(x), _t(w)[:, :5])
    with pytest.raises(ValueError, match="exceeds input length"):
        tsc.conv1d_depthwise(_t(x)[:, :3], _t(w))
    with pytest.raises(ValueError, match="no conv1d_depthwise for device"):
        tsc.conv1d_depthwise(_t(x).to("meta"), _t(w).to("meta"))
    wg = _t(w).requires_grad_(True)
    y = tops.conv1d_depthwise(_t(x), wg)
    assert type(y.grad_fn).__name__ == "Conv1dDepthwiseBackward"
    assert tops.conv1d_depthwise(_t(x), _t(w)).grad_fn is None  # serving
    with pytest.raises(NotImplementedError, match="inference only"):
        tops.conv1d_depthwise(_t(x), wg, precision="w8a16")
    with pytest.raises(ValueError, match="do not form"):
        tsb.conv1d_depthwise_bwd_dw(_t(x), _t(x)[:, :5, :4], 4)
    with pytest.raises(ValueError, match="reads past"):
        tsb.conv1d_depthwise_bwd_dw(_t(x), _t(x), 4)
    with pytest.raises(ValueError, match="no conv1d_depthwise_bwd_dw for"):
        tsb.conv1d_depthwise_bwd_dw(_t(x).to("meta"), _t(x)[:, :5].to("meta"), 4)


# -- float backward ------------------------------------------------------------

def _scaled(want):
    """TOL with atol taken times max(1, max |want|): gradients are sums
    whose terms reach above 1 (tests/test_grads.py ``_close_scaled``)."""
    return dict(rtol=TOL["rtol"],
                atol=TOL["atol"] * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("K,stride,activation,with_bias", list(
    itertools.product((2, 3, 4, 5), (1, 2), ("silu", "none"), (True, False))))
def test_depthwise_grads_match_reference(K, stride, activation, with_bias):
    """``ops.conv1d_depthwise`` under autograd (``Conv1dDepthwise`` on the
    plain versions: dx through the forward conv on the flipped taps, dw and
    db through the dw kernel's plain version) against ``jax.vjp`` of the
    reference's plain depthwise conv with the unfused epilogue, one
    cotangent: y, dx, dw and db within TOL."""
    x, w, b = _inputs(K * 3 + stride, 2, 37, 24, K, with_bias)
    ct = np.random.default_rng(K).normal(
        size=(2, (36 // stride) + 1, 24)).astype(np.float32)

    def jfn(x, w, *b):
        y = jconv.conv1d_depthwise_sliding(x, w, padding="CAUSAL",
                                           stride=stride)
        return jops.epilogue_unfused(y, b[0] if b else None, activation)

    jargs = [jnp.asarray(a) for a in (x, w, b) if a is not None]
    jy, vjp = jax.vjp(jfn, *jargs)
    want = vjp(jnp.asarray(ct))
    targs = [_t(a).requires_grad_(True) for a in (x, w, b) if a is not None]
    y = tops.conv1d_depthwise(targs[0], targs[1], stride=stride,
                              padding="CAUSAL", activation=activation,
                              bias=targs[2] if with_bias else None)
    assert y.shape == jy.shape
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    got = torch.autograd.grad((y * _t(ct)).sum(), targs)
    for name, g, wnt in zip(("dx", "dw", "db"), got, want):
        wnt = np.asarray(wnt)
        np.testing.assert_allclose(g.numpy(), wnt, err_msg=name, **_scaled(wnt))


@pytest.mark.parametrize("K,stride", list(itertools.product((2, 3, 4, 5),
                                                             (1, 2))))
def test_depthwise_bwd_dw_plain_matches_reference(K, stride):
    """The dw kernel's plain version on a padded input and a cotangent
    against ``jax.vjp`` of the reference's VALID depthwise oracle
    (``kernels.ref.conv1d_depthwise_ref``): dw within TOL; db the sum of
    dz; float32 out from bfloat16 operands too."""
    from repro.kernels import ref as jref

    x, w, _ = _inputs(K + 10 * stride, 3, 29, 20, K)
    lout = (29 - K) // stride + 1
    dz = np.random.default_rng(stride).normal(size=(3, lout, 20)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda w: jref.conv1d_depthwise_ref(
        jnp.asarray(x), w, stride=stride), jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(dz))[0])
    dw, db = tsb.conv1d_depthwise_bwd_dw(_t(x), _t(dz), K, stride=stride,
                                         has_bias=True)
    assert dw.dtype == db.dtype == torch.float32 and dw.shape == (K, 20)
    np.testing.assert_allclose(dw.numpy(), want, **_scaled(want))
    np.testing.assert_allclose(db.numpy(), dz.sum(axis=(0, 1)), rtol=1e-5,
                               atol=1e-5)
    assert tsb.conv1d_depthwise_bwd_dw(_t(x), _t(dz), K, stride=stride)[1] is None
    dwb, _ = tsb.conv1d_depthwise_bwd_dw(_t(x).bfloat16(), _t(dz).bfloat16(), K,
                                         stride=stride)
    want_b = tsb.conv1d_depthwise_bwd_dw_plain(
        _t(x).bfloat16().float(), _t(dz).bfloat16().float(), K, stride=stride)[0]
    assert dwb.dtype == torch.float32 and torch.equal(dwb, want_b)


@pytest.mark.parametrize("activation", ACTS)
def test_depthwise_preact_is_the_post_bias_sum(activation):
    """``save_preact``: y as without it, and z the post-bias sum, in x's
    type (the reference's unfused conv + bias, no activation)."""
    x, w, b = _inputs(7, 2, 33, 16, 4)
    y, z = tsc.conv1d_depthwise(_t(x), _t(w), _t(b), stride=2,
                                activation=activation, save_preact=True)
    assert torch.equal(y, tsc.conv1d_depthwise(_t(x), _t(w), _t(b), stride=2,
                                               activation=activation))
    jz = jops.epilogue_unfused(
        jconv.conv1d_depthwise_sliding(jnp.asarray(x), jnp.asarray(w),
                                       padding="VALID", stride=2),
        jnp.asarray(b), "none")
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
    yb, zb = tsc.conv1d_depthwise(_t(x).bfloat16(), _t(w).bfloat16(), _t(b),
                                  activation=activation, save_preact=True)
    assert zb.dtype == torch.bfloat16
    exact = tsc.conv1d_depthwise_plain(_t(x).bfloat16().float(),
                                       _t(w).bfloat16().float(), _t(b))
    assert torch.equal(zb, exact.bfloat16())


# -- int8 --------------------------------------------------------------------

def test_quantize_depthwise_weight_matches_reference():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(3, 4, 40)).astype(np.float32)  # periods stacked
    want = japply.quantize_depthwise_weight(jnp.asarray(w))
    got = tapply.quantize_depthwise_weight(_t(w))
    assert got.q.dtype == torch.int8 and got.scale.shape == (3, 1, 40)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_allclose(got.dequant().numpy(),
                               np.asarray(want.dequant()), rtol=1e-7)


def _q_inputs(seed, B, L, C, K, mode, with_bias=True):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(K, C)).astype(np.float32)
    qw = japply.quantize_depthwise_weight(jnp.asarray(w))
    b = rng.normal(size=(C,)).astype(np.float32) if with_bias else None
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    if mode == "w8a8":
        xs = np.float32(np.abs(x).max() / 127 + 1e-12)
        xq = np.asarray(jq.quantize_act(jnp.asarray(x), xs))
        return xq, qw, b, xs
    return x, qw, b, None


@pytest.mark.parametrize("mode,K,stride,activation", [
    (m, K, s, a) for m, (K, s), a in itertools.product(
        ("w8a8", "w8a16"), [(4, 1), (3, 2), (5, 1)], ("none", "silu", "gelu"))
])
def test_depthwise_q_matches_reference(mode, K, stride, activation):
    """The exact int8 depthwise conv (plain version of the int8 kernel)
    against the reference's, float32 out, then requantized onto a grid
    that clips the largest outputs."""
    x, qw, b, xs = _q_inputs(K * 7 + stride, 2, 33, 24, K, mode)
    args = dict(mode=mode, stride=stride, padding="CAUSAL",
                activation=activation, accumulate="int32")
    jqw = jq.QuantizedWeight(qw.q, qw.scale)
    tqw = tq.QuantizedWeight(_t(qw.q), _t(qw.scale))
    want = np.asarray(jq.conv1d_depthwise_q(
        jnp.asarray(x), jqw, jnp.asarray(b), x_scale=xs, **args))
    got = tq.conv1d_depthwise_q(_t(x), tqw, _t(b), x_scale=xs, **args)
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)
    os = np.float32(np.abs(want).max() * 0.8 / 127)
    want_q = np.asarray(jq.conv1d_depthwise_q(
        jnp.asarray(x), jqw, jnp.asarray(b), x_scale=xs, out_scale=os, **args))
    got_q = tq.conv1d_depthwise_q(_t(x), tqw, _t(b), x_scale=xs, out_scale=os,
                                  **args)
    assert got_q.dtype == torch.int8 and np.abs(want_q).max() == 127
    _codes_equal(got_q.numpy(), want_q, want / os)


def test_depthwise_q_dynamic_scale_and_fast_path_match_reference():
    """A float input in w8a8 with no scale takes the dynamic absmax scale;
    the float32 ("fast") sums equal the exact ones at this size."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 20, 16)).astype(np.float32)
    qw = japply.quantize_depthwise_weight(
        jnp.asarray(rng.normal(size=(4, 16)).astype(np.float32)))
    b = rng.normal(size=(16,)).astype(np.float32)
    tqw = tq.QuantizedWeight(_t(qw.q), _t(qw.scale))
    for acc in ("int32", "fast"):
        want = np.asarray(jq.conv1d_depthwise_q(
            jnp.asarray(x), qw, jnp.asarray(b), activation="silu",
            accumulate=acc))
        got = tq.conv1d_depthwise_q(_t(x), tqw, _t(b), activation="silu",
                                    accumulate=acc)
        np.testing.assert_allclose(got.numpy(), want, **TIGHT)


@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
def test_ops_depthwise_quant_matches_reference_rung(mode):
    """``ops.conv1d_depthwise(precision=...)`` as the mamba conv calls it
    (CAUSAL, bias, silu, int8 weights, dynamic activation scale) against
    the reference's ops, whose jax rung serves here."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 18, 32)).astype(np.float32)
    qw = japply.quantize_depthwise_weight(
        jnp.asarray(rng.normal(size=(4, 32)).astype(np.float32)))
    b = rng.normal(size=(32,)).astype(np.float32)
    want = np.asarray(jops.conv1d_depthwise(
        jnp.asarray(x), qw.q, padding="CAUSAL", bias=jnp.asarray(b),
        activation="silu", precision=mode, w_scale=qw.scale))
    tops.CONV1D_DW_DISPATCH.clear()
    got = tops.conv1d_depthwise(
        _t(x), _t(qw.q), padding="CAUSAL", bias=_t(b), activation="silu",
        precision=mode, w_scale=_t(qw.scale))
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)
    assert tops.CONV1D_DW_DISPATCH.items() == [
        (f"conv1ddw|B2|L21|C32|K4|s1|{mode}", "plain")]


def test_int8_depthwise_wrapper_checks():
    x, qw, b, xs = _q_inputs(1, 2, 10, 8, 4, "w8a8")
    q, s = _t(qw.q), _t(qw.scale)
    y = tsq.conv1d_depthwise_quant(_t(x), q, s, _t(b), x_scale=xs)
    assert y.shape == (2, 7, 8) and y.dtype == torch.float32
    with pytest.raises(TypeError, match="w8a8 takes int8 x"):
        tsq.conv1d_depthwise_quant(_t(x).float(), q, s, x_scale=xs)
    with pytest.raises(TypeError, match="must be int8"):
        tsq.conv1d_depthwise_quant(_t(x), q.float(), s, x_scale=xs)
    with pytest.raises(ValueError, match="w_scale"):
        tsq.conv1d_depthwise_quant(_t(x), q, s[..., :4], x_scale=xs)
    with pytest.raises(ValueError, match="no conv1d_depthwise_quant"):
        tsq.conv1d_depthwise_quant(_t(x).to("meta"), q.to("meta"),
                                   s.to("meta"), x_scale=xs)


def test_quantize_params_depthwise_leaves_match_reference():
    """The depthwise branch of ``quantize_params``: a period-stacked
    ``conv_w`` becomes an int8 leaf with (periods, 1, C) scales; a
    calibrated site scale broadcasts to one per period; an unusable one
    leaves a dynamic scale with a health event."""
    from repro.quant import calibrate as jcal
    from repro_torch.health import HEALTH
    from repro_torch.quant import calibrate as tcal

    rng = np.random.default_rng(6)
    w = rng.normal(size=(2, 4, 24)).astype(np.float32)
    b = np.zeros((2, 24), np.float32)
    site = tcal.conv_site("conv1d_dw", 24, 24, 4)
    assert site == jcal.conv_site("conv1d_dw", 24, 24, 4)
    want = japply.quantize_params(
        {"mamba": {"conv_w": jnp.asarray(w), "conv_b": jnp.asarray(b)}},
        spec={site: {"x_scale": jnp.float32(0.05)}})["mamba"]["conv_w"]
    got = tapply.quantize_params(
        {"mamba": {"conv_w": _t(w), "conv_b": _t(b)}},
        spec={site: {"x_scale": torch.tensor(0.05)}})["mamba"]["conv_w"]
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.x_scale.shape == (2,) == np.asarray(want.x_scale).shape
    np.testing.assert_array_equal(got.x_scale.numpy(), np.asarray(want.x_scale))
    HEALTH.reset()
    bad = tapply.quantize_params(
        {"conv_w": _t(w)}, spec={site: {"x_scale": torch.tensor(float("nan"))}})
    assert bad["conv_w"].x_scale is None and bad["conv_w"].q.dtype == torch.int8
    assert any(site in line and "dynamic_scale" in line
               for line in HEALTH.summary())
    HEALTH.reset()
