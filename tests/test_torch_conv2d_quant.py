"""The port's int8 conv2d against the JAX reference, on the CPU.

The same numpy floats go through the reference's exact quantized conv2d
(``qconv.conv2d_q`` with int32 accumulation, the oracle of its Pallas
kernel), its int8 im2col baseline, its quantized ``patch_embed`` and the
``llava/patch_embed → llava/projector`` requant chain, and through the
port's: ``qconv.conv2d_q`` / ``conv2d_q_im2col``, ``ops.conv2d`` with
``precision`` "w8a8" / "w8a16" (whose int8 conv2d wrapper runs its plain
version on a CPU tensor), ``layers.conv2d_bias_act`` and ``patch_embed``.
Float outputs are held to ``TIGHT`` (``tests/test_quant.py``), times max
|y| where the sums are float32 in another order (w8a16); requantized codes
are equal but for ties (``_codes_equal``, as in
``tests/test_torch_quant.py``): the float32 gelu and silu of PyTorch and
XLA may differ in the last bit. The kernel itself is held to its plain
version on the card by ``tests/test_torch_conv2d_card.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.health import HEALTH as JHEALTH  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import llava as jllava  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.quant import qconv as jq  # noqa: E402
from repro_torch import quant as tquant  # noqa: E402
from repro_torch.health import HEALTH  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sliding_conv_quant as tsq  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import llava as tllava  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.quant import qconv as tq  # noqa: E402

TIGHT = dict(rtol=1e-5, atol=1e-5)  # tests/test_quant.py
TIE = 1e-3  # code units: how near a half-integer float rounding can move
ACTS = ("none", "relu", "gelu", "silu")
# (B, H, W, Cin, Cout, k, stride): k 3, 5, 9 and 31, strides, and the
# patch embedding's Cin = 3 at k = stride = 14
SHAPES = [
    (2, 12, 13, 5, 16, 3, (1, 1)),
    (2, 15, 14, 6, 24, 5, (2, 2)),
    (1, 21, 19, 4, 8, 9, (1, 2)),
    (1, 36, 35, 4, 16, 31, (2, 1)),
    (2, 28, 28, 3, 32, 14, (14, 14)),
]


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


def _close(got, want, scaled=False):
    """TIGHT, with atol taken times max(1, max |want|) where ``scaled``."""
    want = np.asarray(want, np.float32)
    atol = TIGHT["atol"] * (max(1.0, float(np.abs(want).max())) if scaled else 1)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=TIGHT["rtol"], atol=atol)


def _inputs(seed, B, H, W, Cin, Cout, k):
    """Floats scaled so that the outputs are of order one, and a bias."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, Cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, Cin, Cout)) * rng.uniform(0.5, 2.0, size=Cout)
         / np.sqrt(k * k * Cin)).astype(np.float32)
    b = (0.1 * rng.normal(size=(Cout,))).astype(np.float32)
    return x, w, b


def _weights(w, x_scale=None, out_scale=None):
    jw = jq.quantize_weight(jnp.asarray(w), x_scale, out_scale)
    tw = tq.quantize_weight(_t(w), x_scale, out_scale)
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    return jw, tw


# -- qconv.conv2d_q and the im2col baseline --------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
@pytest.mark.parametrize("accumulate", ["int32", "fast"])
def test_conv2d_q_matches_reference(shape, mode, accumulate):
    B, H, W, Cin, Cout, k, stride = shape
    x, w, b = _inputs(k + Cin, B, H, W, Cin, Cout, k)
    jw, tw = _weights(w)
    act = ACTS[k % 4]
    args = dict(mode=mode, stride=stride, padding="VALID", activation=act,
                accumulate=accumulate)
    want = jq.conv2d_q(jnp.asarray(x), jw, jnp.asarray(b), **args)
    got = tq.conv2d_q(_t(x), tw, _t(b), **args)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got.numpy(), want, scaled=mode == "w8a16" or accumulate == "fast")


@pytest.mark.parametrize("activation", ACTS)
def test_conv2d_q_requant_codes_match_reference(activation):
    x, w, b = _inputs(3, 2, 16, 17, 5, 24, 3)
    jw, tw = _weights(w)
    y = np.asarray(jq.conv2d_q(jnp.asarray(x), jw, jnp.asarray(b),
                               padding="SAME", activation=activation))
    os = np.float32(np.abs(y).max() * 0.8 / 127)  # the largest codes clip
    want = jq.conv2d_q(jnp.asarray(x), jw, jnp.asarray(b), padding="SAME",
                       activation=activation, out_scale=jnp.asarray(os))
    got = tq.conv2d_q(_t(x), tw, _t(b), padding="SAME", activation=activation,
                      out_scale=torch.tensor(os))
    assert got.dtype == torch.int8 and np.abs(np.asarray(want)).max() == 127
    _codes_equal(got.numpy(), want, y / os)


@pytest.mark.parametrize("int8_input", [False, True])
def test_conv2d_q_im2col_matches_reference(int8_input):
    x, w, _ = _inputs(4, 2, 28, 28, 3, 32, 14)
    jw, tw = _weights(w)
    xs = np.float32(np.abs(x).max() / 127 + 1e-12)
    if int8_input:
        xq = np.asarray(jq.quantize_act(jnp.asarray(x), jnp.asarray(xs)))
        want = jq.conv2d_q_im2col(jnp.asarray(xq), jw, x_scale=jnp.asarray(xs),
                                  stride=(14, 14))
        got = tq.conv2d_q_im2col(_t(xq), tw, x_scale=torch.tensor(xs),
                                 stride=(14, 14))
    else:
        want = jq.conv2d_q_im2col(jnp.asarray(x), jw, stride=(14, 14))
        got = tq.conv2d_q_im2col(_t(x), tw, stride=(14, 14))
    _close(got.numpy(), want)
    # the baseline and the sliding oracle compute the same function
    exact = tq.conv2d_q(_t(x), tw, stride=(14, 14), x_scale=torch.tensor(xs))
    _close(tq.conv2d_q_im2col(_t(x), tw, x_scale=torch.tensor(xs),
                              stride=(14, 14), accumulate="int32").numpy(),
           exact.numpy())
    with pytest.raises(ValueError, match="needs its x_scale"):
        tq.conv2d_q_im2col(torch.zeros(1, 14, 14, 3, dtype=torch.int8), tw,
                           stride=(14, 14))


# -- ops.conv2d int8 ---------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
def test_ops_conv2d_int8_matches_reference_oracle(shape, mode):
    """Float operands quantized inside ``ops.conv2d``, SAME padding applied
    before the quantization, against the reference's exact oracle on the
    same padded input; logged under the precision-keyed shape key."""
    B, H, W, Cin, Cout, k, stride = shape
    x, w, b = _inputs(2 * k + Cin, B, H, W, Cin, Cout, k)
    act = ACTS[(k + 1) % 4]
    pad = "SAME" if k < 14 else "VALID"
    jw, tw = _weights(w)
    want = jq.conv2d_q(jnp.asarray(x), jw, jnp.asarray(b), mode=mode,
                       stride=stride, padding=pad, activation=act)
    tops.CONV2D_QUANT_DISPATCH.clear()
    got = tops.conv2d(_t(x), _t(w), stride=stride, padding=pad, bias=_t(b),
                      activation=act, precision=mode)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, scaled=mode == "w8a16")
    [(key, impl)] = tops.CONV2D_QUANT_DISPATCH.items()
    assert impl == "plain" and key.endswith(f"|{mode}")


@pytest.mark.parametrize("activation", ["none", "gelu"])
def test_ops_conv2d_int8_codes_in_and_out(activation):
    """An int8 input with its scale and int8 weights with theirs, the
    output requantized: the reference's codes but for ties; bfloat16 x in
    w8a16 gives a bfloat16 output, as ``layers.conv2d_bias_act`` asks."""
    x, w, b = _inputs(7, 2, 17, 18, 6, 16, 5)
    xs = np.float32(np.abs(x).max() / 127 + 1e-12)
    xq = np.asarray(jq.quantize_act(jnp.asarray(x), jnp.asarray(xs)))
    jw, tw = _weights(w)
    y = np.asarray(jq.conv2d_q(jnp.asarray(xq), jw, jnp.asarray(b),
                               x_scale=jnp.asarray(xs), padding="SAME",
                               activation=activation))
    os = np.float32(np.abs(y).max() * 0.9 / 127)
    want = jq.conv2d_q(jnp.asarray(xq), jw, jnp.asarray(b),
                       x_scale=jnp.asarray(xs), out_scale=jnp.asarray(os),
                       padding="SAME", activation=activation)
    got = tops.conv2d(_t(xq), tw.q, padding="SAME", bias=_t(b),
                      activation=activation, precision="w8a8",
                      w_scale=tw.scale, x_scale=torch.tensor(xs),
                      out_scale=torch.tensor(os))
    assert got.dtype == torch.int8
    _codes_equal(got.numpy(), want, y / os)
    xb = _t(x).to(torch.bfloat16)
    yb = tops.conv2d(xb, tw.q, padding="SAME", bias=_t(b), precision="w8a16",
                     w_scale=tw.scale)
    assert yb.dtype == torch.bfloat16
    want = tq.conv2d_q(xb.float(), tw, _t(b), mode="w8a16", padding="SAME")
    np.testing.assert_allclose(yb.float().numpy(), want.numpy(), rtol=1e-2,
                               atol=1e-2)  # one bf16 step


@pytest.mark.parametrize("bad", [0.0, float("nan")])
def test_ops_conv2d_scale_guard_as_reference(bad):
    """An unusable calibrated scale: float weights demote to the fp conv
    (logged "fp"), int8 weights take a dynamic scale, int8 operands raise;
    the health events are the reference's."""
    x, w, b = _inputs(8, 1, 10, 11, 4, 8, 3)
    jw, tw = _weights(w)
    HEALTH.reset()
    JHEALTH.reset()
    tops.CONV2D_QUANT_DISPATCH.clear()
    got = tops.conv2d(_t(x), _t(w), bias=_t(b), precision="w8a8",
                      x_scale=torch.tensor(bad))
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b),
                       precision="w8a8", x_scale=jnp.asarray(bad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)  # the fp conv, tests/test_kernels TOL
    assert torch.equal(got, tops.conv2d(_t(x), _t(w), bias=_t(b)))
    assert [v for _, v in tops.CONV2D_QUANT_DISPATCH.items()] == ["fp"]
    got = tops.conv2d(_t(x), tw.q, bias=_t(b), precision="w8a8",
                      w_scale=tw.scale, x_scale=torch.tensor(bad))
    dyn = tops.conv2d(_t(x), tw.q, bias=_t(b), precision="w8a8",
                      w_scale=tw.scale)
    assert torch.equal(got, dyn)
    jops.conv2d(jnp.asarray(x), jw.q, bias=jnp.asarray(b), precision="w8a8",
                w_scale=jw.scale, x_scale=jnp.asarray(bad))
    xq = torch.zeros(1, 10, 11, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="unusable x_scale"):
        tops.conv2d(xq, tw.q, precision="w8a8", w_scale=tw.scale,
                    x_scale=torch.tensor(bad))
    with pytest.raises(ValueError, match="unusable int8 w_scale"):
        tops.conv2d(_t(x), tw.q, precision="w8a8",
                    w_scale=torch.full_like(tw.scale, bad))

    def guard_events(events):
        return [(e.site, e.reason, e.action) for e in events
                if e.action.startswith(("fallback", "error"))]

    assert guard_events(HEALTH.events)[:2] == guard_events(JHEALTH.events)
    assert [a for _, _, a in guard_events(HEALTH.events)] == [
        "fallback:fp", "fallback:dynamic_scale", "error:x_scale",
        "error:w_scale"]
    HEALTH.reset()
    JHEALTH.reset()


def test_ops_conv2d_int8_refusals():
    x = torch.zeros(1, 8, 9, 3)
    w = torch.zeros(3, 3, 3, 4)
    for backend in ("xla", "im2col_gemm"):
        with pytest.raises(ValueError, match="sliding and sliding_pallas backends only"):
            tops.conv2d(x, w, precision="w8a8", backend=backend)
    with pytest.raises(ValueError, match="dilation == 1 only"):
        tops.conv2d(x, w, precision="w8a8", dilation=(2, 1))
    with pytest.raises(ValueError, match="unknown precision"):
        tops.conv2d(x, w, precision="int4")
    with pytest.raises(NotImplementedError, match="inference only"):
        tops.conv2d(x, w.clone().requires_grad_(), precision="w8a16")
    with pytest.raises(ValueError, match="need their w_scale"):
        tops.conv2d(x, w.to(torch.int8), precision="w8a16")


def test_conv2d_quant_wrapper_checks():
    wq = torch.zeros(3, 3, 4, 8, dtype=torch.int8)
    ws = torch.ones(8)
    x8 = torch.zeros(1, 6, 7, 4, dtype=torch.int8)
    xs = torch.tensor(0.1)
    before = tsq.conv2d_quant.launches
    y = tsq.conv2d_quant(x8, wq, ws, x_scale=xs, stride=(2, 1),
                         regime="compound", tile_h=4)
    assert y.shape == (1, 2, 5, 8) and tsq.conv2d_quant.launches == before
    with pytest.raises(ValueError, match="overflow the int32 sum"):
        tsq.conv2d_quant(torch.zeros(1, 64, 64, 512, dtype=torch.int8),
                         torch.zeros(17, 17, 512, 8, dtype=torch.int8), ws,
                         x_scale=xs)
    with pytest.raises(ValueError, match="w_scale"):
        tsq.conv2d_quant(x8, wq, torch.ones(7), x_scale=xs)
    with pytest.raises(TypeError, match="w8a8 takes int8 x"):
        tsq.conv2d_quant(x8.float(), wq, ws, x_scale=xs)
    with pytest.raises(TypeError, match="w8a16 takes float32 or bfloat16"):
        tsq.conv2d_quant(x8, wq, ws, mode="w8a16")
    with pytest.raises(ValueError, match="exceeds input"):
        tsq.conv2d_quant(x8, torch.zeros(9, 3, 4, 8, dtype=torch.int8), ws,
                         x_scale=xs)
    with pytest.raises(ValueError, match="unknown regime"):
        tsq.conv2d_quant(x8, wq, ws, x_scale=xs, regime="winograd")
    with pytest.raises(ValueError, match="no sliding_conv2d_quant for device"):
        tsq.conv2d_quant(x8.to("meta"), wq.to("meta"), ws.to("meta"),
                         x_scale=xs.to("meta"))


# -- layers, patch_embed and the llava chain ---------------------------------

@pytest.mark.parametrize("backend", ["sliding", "sliding_pallas"])
@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
def test_conv2d_bias_act_quant_matches_reference(backend, mode):
    """The reference's layers.conv2d_bias_act on its pure-JAX quantized path
    ("fast", float32 sums) against the port's: the int8 kernel's plain
    version on ``sliding_pallas``, ``qconv.conv2d_q`` on ``sliding``."""
    x, w, b = _inputs(11, 1, 16, 16, 4, 8, 3)
    xs = np.float32(np.abs(x).max() / 127 + 1e-12)
    jw, tw = _weights(w, jnp.asarray(xs), None)
    tw = tw._replace(x_scale=torch.tensor(xs))
    want = jL.conv2d_bias_act(jnp.asarray(x), jw, jnp.asarray(b),
                              activation="relu", padding="SAME",
                              backend="sliding", precision=mode)
    got = tL.conv2d_bias_act(_t(x), tw, _t(b), activation="relu",
                             padding="SAME", backend=backend, precision=mode)
    _close(got.numpy(), want, scaled=True)


def test_patch_embed_quantized_matches_reference():
    """tests/test_quant.py::test_llava_patch_embed_quantized on both
    packages: the w8a8 patch embedding within 0.1 of the float one, and
    the port's output the reference's."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(14, 14, 3, 32)) * 0.1).astype(np.float32)
    img = rng.normal(size=(1, 28, 28, 3)).astype(np.float32)
    jw, tw = _weights(w)
    f32 = tllava.patch_embed(_t(w), _t(img), backend="sliding_pallas")
    want = jllava.patch_embed(jw, jnp.asarray(img), precision="w8a8")
    for backend in ("sliding", "sliding_pallas"):
        with tquant.counting_dequants() as sites:
            got = tllava.patch_embed(tw, _t(img), backend=backend,
                                     precision="w8a8")
        assert sites == ["llava/patch_embed"]
        assert got.shape == f32.shape == (1, 4, 32)
        rel = (got - f32).abs().max() / (f32.abs().max() + 1e-9)
        assert rel < 0.1
        _close(got.numpy(), want, scaled=True)
    # a float weight with precision "w8a16", quantized at the call
    got = tllava.patch_embed(_t(w), _t(img), backend="sliding_pallas",
                             precision="w8a16")
    want = jllava.patch_embed(jnp.asarray(w), jnp.asarray(img),
                              precision="w8a16")
    _close(got.numpy(), want, scaled=True)


def test_patch_embed_chains_into_projector_as_reference():
    """tests/test_quant.py::test_llava_patch_embed_chains_into_projector on
    both packages: the calibrated chain gives patch_embed the projector's
    input scale as its out_scale, the patch embedding emits int8 codes (the
    reference's but for ties) and the projector is the chain's one dequant
    site; its output within TIGHT of the reference's."""
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
    w = (rng.normal(size=(14, 14, 3, 32)) * 0.05).astype(np.float32)
    pj = {"w1": (rng.normal(size=(32, 16)) * 0.1).astype(np.float32),
          "b1": np.zeros((16,), np.float32),
          "w2": (rng.normal(size=(16, 16)) * 0.1).astype(np.float32)}
    jpj = {k: jnp.asarray(v) for k, v in pj.items()}
    tpj = {k: _t(v) for k, v in pj.items()}
    jcal, tcal = jquant.Calibration(), tquant.Calibration()
    with jquant.collecting(jcal):
        jtransformer.projector_apply(jpj, jllava.patch_embed(
            jnp.asarray(w), jnp.asarray(images)))
    with tquant.collecting(tcal):
        f32 = ttransformer.projector_apply(tpj, tllava.patch_embed(
            _t(w), _t(images), backend="sliding_pallas"))
    jspec = jcal.spec(chains=jquant.CHAINS)
    tspec = tcal.spec(chains=tquant.CHAINS)
    assert tcal.seen == ["llava/patch_embed", "llava/projector"]
    for site, entry in jspec.items():
        for k, v in entry.items():
            np.testing.assert_allclose(float(tspec[site][k]), float(v),
                                       rtol=1e-6)
    pe, pr = jspec["llava/patch_embed"], jspec["llava/projector"]
    jw = jq.quantize_weight(jnp.asarray(w), pe["x_scale"], pe["out_scale"])
    tw = tq.quantize_weight(_t(w), torch.tensor(float(pe["x_scale"])),
                            torch.tensor(float(pe["out_scale"])))
    want_codes = jllava.patch_embed(jw, jnp.asarray(images), precision="w8a8")
    want = jtransformer.projector_apply(jpj, want_codes, x_scale=pr["x_scale"])
    y = np.asarray(jq.conv2d_q(jnp.asarray(images), jw._replace(out_scale=None),
                               stride=(14, 14)))
    for backend in ("sliding", "sliding_pallas"):
        with tquant.counting_dequants() as sites:
            codes = tllava.patch_embed(tw, _t(images), backend=backend,
                                       precision="w8a8")
            assert codes.dtype == torch.int8
            got = ttransformer.projector_apply(
                tpj, codes, x_scale=torch.tensor(float(pr["x_scale"])))
        assert sites == ["llava/projector"]
        _codes_equal(codes.numpy(), want_codes,
                     y.reshape(codes.shape) / float(pe["out_scale"]))
        _close(got.numpy(), want, scaled=True)
        rel = (got - f32).abs().max() / (f32.abs().max() + 1e-9)
        assert rel < 0.15
