"""The port's int8 quantization against the JAX reference, on the CPU.

The same numpy floats go through the reference's quantizers, calibration,
``quantize_params`` and exact quantized conv (``qconv.conv1d_q`` with
int32 accumulation, the oracle of its Pallas kernel) and through the
port's: codes and scales bit-equal, calibrated scales within 1e-6, conv
outputs within ``TIGHT`` (``tests/test_quant.py``) and requantized codes
equal. The port's conv wrapper runs its plain version on a CPU tensor.

Two float32 computations of one activation may differ in the last bit
(PyTorch's and XLA's gelu and silu do for about a third of inputs, and
float32 sums run in another order). A requantized code can then differ by
one where the reference's ``y / out_scale`` lies within float rounding of a
half-integer; ``_codes_equal`` allows exactly that and nothing else.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.health import HEALTH as JHEALTH  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.quant import apply as japply  # noqa: E402
from repro.quant import calibrate as jcal  # noqa: E402
from repro.quant import qconv as jq  # noqa: E402
from repro_torch.health import HEALTH  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sliding_conv_quant as tsq  # noqa: E402
from repro_torch.optim import compress as tcompress  # noqa: E402
from repro_torch.quant import apply as tapply  # noqa: E402
from repro_torch.quant import calibrate as tcal  # noqa: E402
from repro_torch.quant import qconv as tq  # noqa: E402

TIGHT = dict(rtol=1e-5, atol=1e-5)  # tests/test_quant.py
TIE = 1e-3  # code units: how near a half-integer float rounding can move


def _t(a):
    return torch.from_numpy(np.array(a))  # an owned, writable copy


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


# -- quantizers ------------------------------------------------------------

def _tie_matrix(rng, rows, cols):
    """Floats with exact .5 ties on a scale of exactly 1: each column (and
    row) reaches |127|, so max/127 + 1e-12 rounds to 1.0 in float32."""
    w = rng.integers(-120, 120, size=(rows, cols)).astype(np.float32) + 0.5
    w[0, :] = 127.0
    w[:, 0] = -127.0
    return w


@pytest.mark.parametrize("shape", [(3, 37, 24), (1, 80, 16), (5, 7, 3)])
def test_quantize_weight_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    w = (rng.normal(size=shape) * rng.uniform(0.01, 3.0, size=shape[-1])
         ).astype(np.float32)
    want = jq.quantize_weight(jnp.asarray(w))
    got = tq.quantize_weight(_t(w))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_quantizers_round_ties_to_even_as_reference():
    rng = np.random.default_rng(4)
    w = _tie_matrix(rng, 40, 12)
    want = jq.quantize_weight(jnp.asarray(w))
    got = tq.quantize_weight(_t(w))
    assert float(got.scale[0]) == 1.0
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.q.numpy()[1:, 1:],
                                  np.round(w[1:, 1:]).astype(np.int8))
    # per-row int8 (the KV cache's quantizer)
    x = _tie_matrix(rng, 12, 40)
    x[:, 0] = 127.0
    wq, ws = jcompress.quantize_int8(jnp.asarray(x))
    q, s = tcompress.quantize_int8(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(
        tcompress.dequantize_int8(q, s).numpy(),
        np.asarray(jcompress.dequantize_int8(wq, ws)))
    # per-tensor activations on a given scale, ties and the clip
    a = np.concatenate([np.arange(-140, 140) + 0.5, [0.5, -0.5, 1.5, -2.5]]
                       ).astype(np.float32)
    for scale in (1.0, 0.5, 0.0625):
        np.testing.assert_array_equal(
            tq.quantize_act(_t(a * scale), scale).numpy(),
            np.asarray(jq.quantize_act(jnp.asarray(a * scale), scale)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_act_scale_and_int8_rows_match_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_t(3, size=(4, 9, 33)) * 0.7).astype(np.float32)
    np.testing.assert_array_equal(tq.act_scale(_t(x)).numpy(),
                                  np.asarray(jq.act_scale(jnp.asarray(x))))
    s = tq.act_scale(_t(x))
    np.testing.assert_array_equal(
        tq.quantize_act(_t(x), s).numpy(),
        np.asarray(jq.quantize_act(jnp.asarray(x), jnp.asarray(s.numpy()))))
    wq, ws = jcompress.quantize_int8(jnp.asarray(x))
    q, sc = tcompress.quantize_int8(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(ws))
    assert sc.shape == (4, 9, 1)


# -- calibration -------------------------------------------------------------

def _calib_stream(seed):
    rng = np.random.default_rng(seed)
    return [
        ("whisper/conv1", rng.normal(size=(2, 40, 80)).astype(np.float32)),
        ("whisper/conv2", (rng.standard_t(2, size=(2, 40, 64)) * 0.3
                           ).astype(np.float32)),
        ("whisper/conv1", rng.normal(size=(3, 50, 80)).astype(np.float32) * 2),
        ("whisper/conv2", rng.normal(size=(2, 90, 64)).astype(np.float32)),
        ("edge/c1", np.zeros((1, 8, 4), np.float32)),
    ]


@pytest.mark.parametrize("percentile,reservoir", [(99.9, 8192), (99.0, 512),
                                                  (None, 8192)])
def test_calibration_matches_reference(percentile, reservoir):
    jc = jcal.Calibration(percentile=percentile, reservoir=reservoir, seed=3)
    tc = tcal.Calibration(percentile=percentile, reservoir=reservoir, seed=3)
    with jcal.collecting(jc), tcal.collecting(tc):
        for site, x in _calib_stream(7):
            jcal.observe(site, jnp.asarray(x))
            tcal.observe(site, _t(x))
        # int8 codes are not activations: neither side records them
        jcal.observe("whisper/conv2", jnp.zeros((1, 4, 64), jnp.int8))
        tcal.observe("whisper/conv2", torch.zeros((1, 4, 64), dtype=torch.int8))
    assert tc.seen == jc.seen
    for site in tc.seen:
        ts, js = tc.stats[site], jc.stats[site]
        assert ts.batches == js.batches
        np.testing.assert_array_equal(ts.vals, js.vals)
        np.testing.assert_array_equal(ts.absmax, js.absmax)
        np.testing.assert_allclose(tc.site_scale(site).numpy(),
                                   np.asarray(jc.site_scale(site)), rtol=1e-6)
    jspec = jc.spec(chains=japply.CHAINS)
    tspec = tc.spec(chains=tapply.CHAINS)
    assert {s: sorted(e) for s, e in tspec.items()} == {
        s: sorted(e) for s, e in jspec.items()}
    assert "out_scale" in tspec["whisper/conv1"]
    assert "out_scale" not in tspec["whisper/conv2"]
    for site, e in tspec.items():
        for k, v in e.items():
            assert v.dtype == torch.float32 and v.shape == ()
            np.testing.assert_allclose(v.numpy(), np.asarray(jspec[site][k]),
                                       rtol=1e-6)


def test_observe_is_inert_outside_collecting_and_dequants_are_counted():
    tc = tcal.Calibration()
    tcal.observe("a", torch.ones(2, 3))
    assert tc.seen == []
    with tcal.counting_dequants() as log:
        tcal.note_dequant("s1")
        with tcal.counting_dequants() as inner:
            tcal.note_dequant("s2")
        tcal.note_dequant("s3")
    assert log == ["s1", "s3"] and inner == ["s2"]
    tcal.note_dequant("nobody listens")
    assert tcal.conv_site("conv1d", 8, 16, 3) == jcal.conv_site("conv1d", 8, 16, 3)


# -- quantize_params -----------------------------------------------------------

def _frontend_params(seed):
    rng = np.random.default_rng(seed)
    return {
        "frontend": {
            "conv1_w": rng.normal(size=(3, 80, 32)).astype(np.float32) * 0.2,
            "conv1_b": rng.normal(size=(32,)).astype(np.float32),
            "conv2_w": rng.normal(size=(3, 32, 32)).astype(np.float32) * 0.2,
            "conv2_b": rng.normal(size=(32,)).astype(np.float32),
        },
        "enc_norm": np.ones(32, np.float32),
    }


def _spec_pair(entries):
    jspec = {s: {k: jnp.asarray(v, jnp.float32) for k, v in e.items()}
             for s, e in entries.items()}
    tspec = {s: {k: torch.tensor(v, dtype=torch.float32) for k, v in e.items()}
             for s, e in entries.items()}
    return jspec, tspec


def _to_torch_tree(tree):
    return {k: _to_torch_tree(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def test_quantize_params_matches_reference():
    params = _frontend_params(5)
    jspec, tspec = _spec_pair({
        "whisper/conv1": {"x_scale": 0.031, "out_scale": 0.0125},
        "whisper/conv2": {"x_scale": 0.0125},
    })
    jqp = japply.quantize_params(
        {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
         else jnp.asarray(v) for k, v in params.items()}, spec=jspec)
    tqp = tapply.quantize_params(_to_torch_tree(params), spec=tspec)
    assert tapply.quantized_site_count(tqp) == japply.quantized_site_count(jqp) == 2
    for key in ("conv1_w", "conv2_w"):
        got, want = tqp["frontend"][key], jqp["frontend"][key]
        assert isinstance(got, tq.QuantizedWeight)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
        np.testing.assert_array_equal(got.x_scale.numpy(),
                                      np.asarray(want.x_scale))
        assert (got.out_scale is None) == (want.out_scale is None)
    assert tqp["frontend"]["conv1_w"].out_scale is not None  # the chain
    assert tqp["frontend"]["conv2_w"].out_scale is None
    for key in ("conv1_b", "conv2_b"):
        assert torch.equal(tqp["frontend"][key], _t(params["frontend"][key]))


@pytest.mark.parametrize("bad", [0.0, float("nan")])
def test_quantize_params_screens_bad_scales_as_reference(bad):
    params = _frontend_params(6)
    entries = {"whisper/conv1": {"x_scale": 0.02, "out_scale": bad},
               "whisper/conv2": {"x_scale": bad}}
    jspec, tspec = _spec_pair(entries)
    HEALTH.reset()
    JHEALTH.reset()
    jqp = japply.quantize_params(
        {"frontend": {k: jnp.asarray(v) for k, v in params["frontend"].items()}},
        spec=jspec)
    tqp = tapply.quantize_params(
        {"frontend": _to_torch_tree(params["frontend"])}, spec=tspec)
    # conv1 keeps w8a8 but breaks its chain; conv2 stays float
    assert tqp["frontend"]["conv1_w"].out_scale is None
    assert not isinstance(tqp["frontend"]["conv2_w"], tq.QuantizedWeight)
    assert not isinstance(jqp["frontend"]["conv2_w"], jq.QuantizedWeight)
    want = [(e.site, e.reason, e.action) for e in JHEALTH.events]
    assert [(e.site, e.reason, e.action) for e in HEALTH.events] == want
    assert len(want) == 2
    HEALTH.reset()
    JHEALTH.reset()


def test_health_record_dedups_and_refuses_unknown_reasons(capsys):
    HEALTH.reset()
    HEALTH.record("s", "quant_scale_zero", "fallback:fp")
    HEALTH.record("s", "quant_scale_zero", "fallback:fp")
    assert HEALTH.summary() == [
        "site=s reason=quant_scale_zero action=fallback:fp x2"]
    assert capsys.readouterr().err.count("[health]") == 1
    with pytest.raises(ValueError, match="unknown health reason"):
        HEALTH.record("s", "no_such_reason", "x")
    HEALTH.reset()


# -- the quantized conv ------------------------------------------------------

ACTS = ("none", "relu", "gelu", "silu")


def _qconv_case(seed, K, stride, cin, cout=24, B=2, L=45):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L + K, cin)).astype(np.float32)
    w = (rng.normal(size=(K, cin, cout)) / np.sqrt(K * cin)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32) * 0.5
    return x, w, b


@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
@pytest.mark.parametrize("cin", [37, 80])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("K", [1, 3, 5, 7, 17, 20])
def test_conv1d_quant_plain_matches_reference(K, stride, cin, mode):
    """The wrapper on CPU tensors (its plain version) against the exact
    ``conv1d_q``, every activation, requant off and on."""
    x, w, b = _qconv_case(K * 100 + stride * 10 + cin, K, stride, cin)
    jqw = jq.quantize_weight(jnp.asarray(w))
    sx = jq.act_scale(jnp.asarray(x))
    if mode == "w8a8":
        jx = jq.quantize_act(jnp.asarray(x), sx)
        tx, xs = _t(np.asarray(jx)), torch.tensor(float(sx))
    else:
        jx, tx, xs = jnp.asarray(x), _t(x), None
    wq, ws = _t(np.asarray(jqw.q)), _t(np.asarray(jqw.scale))
    for act in ACTS:
        args = dict(mode=mode, stride=stride, activation=act)
        want = np.asarray(jq.conv1d_q(
            jx, jqw, jnp.asarray(b), x_scale=sx if mode == "w8a8" else None,
            accumulate="int32", **args))
        got = tsq.conv1d_quant(tx, wq, ws, _t(b), x_scale=xs, **args)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TIGHT, err_msg=act)
        out_scale = float(np.abs(want).max()) / 127.0 * 0.8  # some clip
        want_q = np.asarray(jq.conv1d_q(
            jx, jqw, jnp.asarray(b), x_scale=sx if mode == "w8a8" else None,
            out_scale=jnp.float32(out_scale), accumulate="int32", **args))
        got_q = tsq.conv1d_quant(tx, wq, ws, _t(b), x_scale=xs,
                                 out_scale=torch.tensor(out_scale), **args)
        assert got_q.dtype == torch.int8
        assert np.abs(want_q).max() == 127  # the clip is exercised
        _codes_equal(got_q.numpy(), want_q,
                     want / np.float32(out_scale))


@pytest.mark.parametrize("K,stride", [(3, 1), (3, 2), (17, 1)])
def test_conv1d_q_fast_and_bf16_match_reference(K, stride):
    """``accumulate="fast"`` (the layers' path off the kernel backend) and
    a bfloat16 w8a16 input with no bias."""
    x, w, b = _qconv_case(K + stride, K, stride, 40)
    jqw = jq.quantize_weight(jnp.asarray(w))
    tqw = tq.QuantizedWeight(_t(np.asarray(jqw.q)), _t(np.asarray(jqw.scale)))
    for mode in ("w8a8", "w8a16"):
        want = np.asarray(jq.conv1d_q(jnp.asarray(x), jqw, jnp.asarray(b),
                                      mode=mode, stride=stride, padding="SAME",
                                      activation="gelu", accumulate="fast"))
        got = tq.conv1d_q(_t(x), tqw, _t(b), mode=mode, stride=stride,
                          padding="SAME", activation="gelu", accumulate="fast")
        np.testing.assert_allclose(got.numpy(), want, **TIGHT, err_msg=mode)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jq.conv1d_q(xb, jqw, None, mode="w8a16", stride=stride,
                                  out_dtype=jnp.bfloat16).astype(jnp.float32))
    got = tsq.conv1d_quant(_t(x).to(torch.bfloat16), tqw.q, tqw.scale,
                           mode="w8a16", stride=stride,
                           out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_ops_conv1d_quant_matches_reference_and_guards_scales(capsys):
    """``ops.conv1d(precision=...)`` pads, quantizes float operands and runs
    the kernel's plain version; unusable scales degrade as the
    reference's ``_guard_quant_scales`` does."""
    x, w, b = _qconv_case(11, 3, 1, 16, L=30)
    jqw = jq.quantize_weight(jnp.asarray(w))
    sx = jq.act_scale(jnp.asarray(x))
    want = np.asarray(jq.conv1d_q(jnp.asarray(x), jqw, jnp.asarray(b),
                                  x_scale=sx, padding="SAME",
                                  activation="relu"))
    got = tops.conv1d(_t(x), _t(w), padding="SAME", backend="sliding_pallas",
                      bias=_t(b), activation="relu", precision="w8a8")
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)
    wq, ws = _t(np.asarray(jqw.q)), _t(np.asarray(jqw.scale))
    HEALTH.reset()
    # int8 weights, float input, zero scale: a dynamic absmax scale instead
    got = tops.conv1d(_t(x), wq, padding="SAME", backend="sliding_pallas",
                      bias=_t(b), activation="relu", precision="w8a8",
                      w_scale=ws, x_scale=torch.tensor(0.0))
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)
    # float weights, NaN scale: the float conv
    got = tops.conv1d(_t(x), _t(w), padding="SAME", backend="sliding_pallas",
                      bias=_t(b), activation="relu", precision="w8a8",
                      x_scale=torch.tensor(float("nan")))
    fp = tops.conv1d(_t(x), _t(w), padding="SAME", backend="sliding_pallas",
                     bias=_t(b), activation="relu")
    assert torch.equal(got, fp)
    # int8 input with an unusable scale cannot be recovered
    with pytest.raises(ValueError, match="unusable x_scale"):
        tops.conv1d(torch.zeros((1, 8, 16), dtype=torch.int8), wq,
                    backend="sliding_pallas", precision="w8a8", w_scale=ws,
                    x_scale=torch.tensor(-1.0))
    assert [(e.site, e.reason, e.action) for e in HEALTH.events] == [
        ("conv1d.w8a8", "quant_scale_zero", "fallback:dynamic_scale"),
        ("conv1d.w8a8", "quant_scale_nan", "fallback:fp"),
        ("conv1d.w8a8", "quant_scale_zero", "error:x_scale"),
    ]
    HEALTH.reset()
    with pytest.raises(ValueError, match="sliding_pallas backend only"):
        tops.conv1d(_t(x), _t(w), backend="sliding", precision="w8a8")


def test_quant_wrapper_refuses_bad_inputs_and_other_devices():
    wq = torch.zeros((3, 8, 4), dtype=torch.int8)
    ws = torch.ones(4)
    with pytest.raises(TypeError, match="w8a8 takes int8 x"):
        tsq.conv1d_quant(torch.zeros(1, 9, 8), wq, ws, mode="w8a8")
    with pytest.raises(TypeError, match="w8a16 takes float32"):
        tsq.conv1d_quant(torch.zeros((1, 9, 8), dtype=torch.int8), wq, ws,
                         mode="w8a16")
    with pytest.raises(ValueError, match="exceeds input length"):
        tsq.conv1d_quant(torch.zeros(1, 2, 8), wq, ws, mode="w8a16")
    with pytest.raises(ValueError, match="no sliding_conv_quant for device"):
        tsq.conv1d_quant(torch.empty((1, 9, 8), device="meta"),
                         wq.to("meta"), ws.to("meta"), mode="w8a16")
