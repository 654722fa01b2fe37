"""Gradients of the port's sliding conv2d against the JAX reference, on the
CPU.

``ops.conv2d`` on the sliding backends differentiates through the port's
``Conv2dSliding`` autograd Function (the forward 2-D kernel with its saved
pre-activation, dx through the forward kernel on the dilated gradient, dw
and db through the 2-D weight-gradient kernel); on CPU tensors those run
their plain versions. The reference side is ``jax.grad`` of the
reference's own ``ops.conv2d``, whose custom VJP's Pallas rung demotes
here to its compiled twin (the jax in this container has no
``pl.unblocked``), over the cases of ``tests/test_grads.py`` and a few
more (kh ≠ kw, strides (2, 1) and (1, 3), every activation, the patch
embedding's Cin = 3 at k = stride = 14), at that file's tolerances:
float32 within rtol 1e-4 and 1e-5 of max |grad| (sums in another order),
bfloat16 within 5e-2 of each. The dx operand helpers are held to the
reference's functions, which are pure JAX; the 2-D dw plain version to
``jax.vjp`` of the reference's library conv (``core.conv.conv2d_xla``).
The reference's grads of a case are computed once for both backends.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import conv as jconv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sliding_conv_bwd as jbwd  # noqa: E402
from repro.models import llava as jllava  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sliding_conv2d as ts2  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as tbwd  # noqa: E402
from repro_torch.models import llava as tllava  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402

# tests/test_grads.py: float32 sums in another order; bfloat16 a few steps
F32 = dict(rtol=1e-4, atol_frac=1e-5)
BF16 = dict(rtol=5e-2, atol_frac=5e-2)
TOL = dict(rtol=3e-4, atol=3e-4)  # forward values, tests/test_kernels.py
ACTS = ("none", "relu", "gelu", "silu")
# (kh, kw, stride, activation, H, W, Cin): tests/test_grads.py's three
# cases first, then kh != kw, more strides and activations, and the patch
# embedding's shape
CASES = [
    (3, 3, (1, 1), "relu", 20, 18, 8),
    (5, 5, (2, 2), "none", 20, 18, 8),
    (19, 19, (1, 1), "none", 22, 22, 8),
    (3, 5, (2, 1), "gelu", 17, 19, 6),
    (7, 7, (1, 3), "silu", 16, 23, 5),
    (14, 14, (14, 14), "none", 28, 42, 3),
]


def _close_scaled(got, want, rtol, atol_frac):
    """allclose with atol proportional to the gradient's magnitude
    (tests/test_grads.py)."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_frac * scale)


def _inputs(seed, B, H, W, Cin, Cout, kh, kw):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, Cin)).astype(np.float32)
    w = rng.normal(size=(kh, kw, Cin, Cout)).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    return x, w, b


_REFERENCE_GRADS = {}


def _reference_grads(case, x, w, b):
    """jax.grad of the reference's ``ops.conv2d`` for a case of CASES,
    computed once."""
    if case not in _REFERENCE_GRADS:
        kh, kw, stride, act = case[:4]

        def f(x, w, b):
            y = jops.conv2d(x, w, stride=stride, bias=b, activation=act,
                            tile_h=8, tile_w=8)
            return jnp.sum(y ** 2)

        _REFERENCE_GRADS[case] = jax.grad(f, (0, 1, 2))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return _REFERENCE_GRADS[case]


def _leaves(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]


@pytest.mark.parametrize("kh,kw,stride,act,H,W,Cin", CASES)
@pytest.mark.parametrize("backend", ["sliding", "sliding_pallas"])
def test_conv2d_grads_match_reference(kh, kw, stride, act, H, W, Cin,
                                      backend):
    x, w, b = _inputs(kh * 10 + kw, 2, H, W, Cin, 16, kh, kw)
    want = _reference_grads((kh, kw, stride, act, H, W, Cin), x, w, b)
    xt, wt, bt = _leaves(x, w, b)
    y = tops.conv2d(xt, wt, stride=stride, bias=bt, activation=act,
                    backend=backend, tile_h=8, tile_w=8)
    assert type(y.grad_fn).__name__ == "Conv2dSlidingBackward"
    got = torch.autograd.grad((y ** 2).sum(), (xt, wt, bt))
    for g, r in zip(got, want):
        _close_scaled(g.numpy(), r, **F32)


def test_conv2d_grad_channel_blocked():
    """tests/test_grads.py::test_conv2d_grad_channel_blocked: the blocking
    arguments reach the backward's dw call and change nothing."""
    x, w, _ = _inputs(12, 1, 20, 18, 12, 20, 3, 3)
    f = lambda x, w: jnp.sum(jops.conv2d(  # noqa: E731
        x, w, tile_h=8, tile_w=8, cin_block=5, cout_block=8) ** 2)
    want = jax.grad(f, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _leaves(x, w)
    y = tops.conv2d(xt, wt, tile_h=8, tile_w=8, cin_block=5, cout_block=8,
                    bwd_tile_h=4, bwd_tile_w=4)
    got = torch.autograd.grad((y ** 2).sum(), (xt, wt))
    for g, r in zip(got, want):
        _close_scaled(g.numpy(), r, **F32)


def test_conv2d_grad_bf16():
    """tests/test_grads.py::test_conv2d_grad_bf16: bfloat16 grads, dz cast
    to x's type and dw cast to w's, within a few bf16 steps."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 16, 16, 8)).astype(np.float32)
    w = rng.normal(size=(3, 3, 8, 8)).astype(np.float32)
    f = lambda x, w: jnp.sum(jops.conv2d(  # noqa: E731
        x, w, activation="relu", tile_h=8, tile_w=8).astype(jnp.float32) ** 2)
    want = jax.grad(f, (0, 1))(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(w).astype(jnp.bfloat16))
    xt, wt = _leaves(x, w, dtype=torch.bfloat16)
    y = tops.conv2d(xt, wt, activation="relu", tile_h=8, tile_w=8)
    got = torch.autograd.grad((y.float() ** 2).sum(), (xt, wt))
    for g, r in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close_scaled(g.float().numpy(), np.asarray(r, np.float32), **BF16)


@pytest.mark.parametrize("backend", ["xla", "im2col_gemm"])
def test_other_backends_differentiate_by_autograd(backend):
    """``xla`` and ``im2col_gemm`` take plain autograd through their
    twins and agree with the kernels' Function."""
    x, w, b = _inputs(5, 2, 12, 13, 4, 6, 3, 3)
    grads = []
    for bk in (backend, "sliding"):
        xt, wt, bt = _leaves(x, w, b)
        y = tops.conv2d(xt, wt, bias=bt, activation="gelu", padding="SAME",
                        backend=bk)
        grads.append(torch.autograd.grad((y ** 2).sum(), (xt, wt, bt)))
    for g, r in zip(*grads):
        _close_scaled(g.numpy(), r.numpy(), **F32)


def test_image_grad_is_not_computed(monkeypatch):
    """Only w and b need a gradient (the patch embedding's images): the
    backward runs no dx conv and one dw call; a differentiable call is
    logged under the reference's grad=True key."""
    calls = []
    monkeypatch.setattr(tbwd, "conv2d_dx", lambda *a, **k: calls.append(a))
    x, w, b = _inputs(6, 2, 28, 28, 3, 8, 14, 14)
    _, wt, bt = _leaves(x, w, b)
    tops.CONV2D_DISPATCH.clear()
    y = tops.conv2d(torch.from_numpy(x), wt, stride=(14, 14), bias=bt)
    gw, gb = torch.autograd.grad(y.sum(), (wt, bt))
    assert calls == [] and gw.shape == wt.shape and gb.shape == bt.shape
    assert [k for k, _ in tops.CONV2D_DISPATCH.items()] == [
        "conv2d|B2|H28|W28|Cin3|Cout8|K14x14|s14x14|float32",
        "conv2d|B2|H28|W28|Cin3|Cout8|K14x14|s14x14|float32|grad"]
    with torch.no_grad():  # serving saves nothing and logs no grad key
        tops.CONV2D_DISPATCH.clear()
        tops.conv2d(torch.from_numpy(x), wt, stride=(14, 14), bias=bt)
        assert len(tops.CONV2D_DISPATCH.items()) == 1


def test_patch_embed_projector_loss_grads_match_reference():
    """A gradient step's grads through ``patch_embed`` on the kernels'
    Function into the projector: the patch weight, its bias and the
    projector's three leaves, against ``jax.grad`` of the reference's
    ``patch_embed`` (on its library conv, which compiles in a fraction of
    its sliding twin's time) and ``projector_apply``."""
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(2, 28, 28, 3)).astype(np.float32)
    leaves = {
        "w": (rng.normal(size=(14, 14, 3, 32)) / np.sqrt(588)).astype(np.float32),
        "b": (0.1 * rng.normal(size=(32,))).astype(np.float32),
        "w1": (rng.normal(size=(32, 24)) / np.sqrt(32)).astype(np.float32),
        "b1": (0.1 * rng.normal(size=(24,))).astype(np.float32),
        "w2": (rng.normal(size=(24, 16)) / np.sqrt(24)).astype(np.float32),
    }
    target = rng.normal(size=(2, 4, 16)).astype(np.float32)

    def jloss(p):
        patches = jllava.patch_embed(p["w"], jnp.asarray(img), backend="xla",
                                     bias=p["b"])
        out = jtransformer.projector_apply(
            {k: p[k] for k in ("w1", "b1", "w2")}, patches)
        return jnp.mean((out - target) ** 2)

    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in leaves.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in leaves.items()}
    patches = tllava.patch_embed(tp["w"], torch.from_numpy(img),
                                 backend="sliding_pallas", bias=tp["b"])
    out = ttransformer.projector_apply(
        {k: tp[k] for k in ("w1", "b1", "w2")}, patches)
    loss = ((out - torch.from_numpy(target)) ** 2).mean()
    np.testing.assert_allclose(loss.item(), float(jloss(
        {k: jnp.asarray(v) for k, v in leaves.items()})), rtol=1e-5)
    got = torch.autograd.grad(loss, list(tp.values()))
    for g, k in zip(got, tp):
        _close_scaled(g.numpy(), want[k], **F32)


# -- the pieces ---------------------------------------------------------------

@pytest.mark.parametrize("stride", [(1, 1), (2, 3), (14, 14)])
def test_dx_operands_match_reference(stride):
    rng = np.random.default_rng(stride[0] + stride[1])
    dz = rng.normal(size=(2, 4, 5, 6)).astype(np.float32)
    w = rng.normal(size=(3, 2, 7, 6)).astype(np.float32)
    jd, jw = jbwd.conv2d_dx_operands(jnp.asarray(dz), jnp.asarray(w),
                                     stride=stride)
    td, tw = tbwd.conv2d_dx_operands(torch.from_numpy(dz), torch.from_numpy(w),
                                     stride=stride)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(
        tbwd.dilate2d(torch.from_numpy(dz), stride).numpy(),
        np.asarray(jbwd.dilate2d(jnp.asarray(dz), stride)))
    for axis, L in ((1, 9), (2, 11), (1, 2)):
        np.testing.assert_array_equal(
            tbwd._fit_len(torch.from_numpy(dz), L, axis).numpy(),
            np.asarray(jbwd._fit_len(jnp.asarray(dz), L, axis)))


@pytest.mark.parametrize("kh,kw,stride", [(3, 3, (1, 1)), (5, 2, (2, 3)),
                                          (14, 14, (14, 14)), (1, 1, (2, 2))])
@pytest.mark.parametrize("has_bias", [True, False])
def test_dw_plain_matches_reference_vjp(kh, kw, stride, has_bias):
    """dw and db of the plain version against ``jax.vjp`` of the
    reference's library conv on the same cotangent; the wrapper runs it on
    a CPU tensor without counting a launch."""
    x, w, _ = _inputs(kh + kw, 2, 30, 31, 3, 5, kh, kw)
    y, vjp = jax.vjp(lambda w: jconv.conv2d_xla(jnp.asarray(x), w,
                                                stride=stride), jnp.asarray(w))
    dz = np.random.default_rng(0).normal(size=y.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(dz))
    before = tbwd.conv2d_bwd_dw.launches
    dw, db = tbwd.conv2d_bwd_dw(torch.from_numpy(x), torch.from_numpy(dz),
                                (kh, kw), stride=stride, has_bias=has_bias)
    assert tbwd.conv2d_bwd_dw.launches == before
    assert dw.dtype == torch.float32 and dw.shape == (kh, kw, 3, 5)
    _close_scaled(dw.numpy(), want, **F32)
    if has_bias:
        _close_scaled(db.numpy(), dz.sum(axis=(0, 1, 2)), **F32)
    else:
        assert db is None


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_save_preact_is_the_post_bias_sum(activation, dtype):
    """``save_preact``: y as without it, and z the post-bias sum in x's
    type (the reference's ``conv2d_sliding_pallas`` residual)."""
    x, w, b = _inputs(9, 2, 12, 11, 5, 7, 3, 2)
    xt = torch.from_numpy(x).to(dtype)
    wt = torch.from_numpy(w / np.sqrt(30)).to(dtype)
    bt = torch.from_numpy(b)
    y, z = ts2.conv2d_sliding(xt, wt, bt, stride=(2, 1), activation=activation,
                              save_preact=True)
    assert torch.equal(y, ts2.conv2d_sliding(xt, wt, bt, stride=(2, 1),
                                             activation=activation))
    assert z.dtype == dtype
    pre = ts2.conv2d_sliding_plain(xt.float(), wt.float(), bt, stride=(2, 1))
    np.testing.assert_allclose(z.float().numpy(), pre.numpy(),
                               **(TOL if dtype == torch.float32
                                  else dict(rtol=1e-2, atol=1e-2)))


def test_dw_wrapper_checks():
    x = torch.zeros(1, 8, 9, 3)
    dz = torch.zeros(1, 6, 7, 4)
    with pytest.raises(ValueError, match="reads past"):
        tbwd.conv2d_bwd_dw(x, dz, (4, 3))
    with pytest.raises(ValueError, match="do not form"):
        tbwd.conv2d_bwd_dw(x[0], dz, (3, 3))
    with pytest.raises(ValueError, match="must be >= 1"):
        tbwd.conv2d_bwd_dw(x, dz, (3, 3), stride=(0, 1))
    with pytest.raises(ValueError, match="tile_w"):
        tbwd.conv2d_bwd_dw(x, dz, (3, 3), tile_w=0)
    with pytest.raises(ValueError, match="no conv2d_bwd_dw for device"):
        tbwd.conv2d_bwd_dw(x.to("meta"), dz.to("meta"), (3, 3))
