"""Gradients of the port's sliding conv1d against the JAX reference, on the
CPU.

``ops.conv1d(..., backend="sliding_pallas")`` differentiates through the
port's ``Conv1dSliding`` autograd Function (forward kernel with the saved
pre-activation, dx through the forward kernel, dw/db through the dw
kernel); on CPU tensors those run their plain versions. The reference
side is ``jax.grad`` of ``repro.kernels.ref.conv1d_ref`` plus the unfused
epilogue, as ``tests/test_grads.py`` does: the reference's own Pallas
kernels fail at trace under the jax in this container. ``act_bwd`` and the
dx operand helpers are held to the reference's functions, which are pure
JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import sliding_conv_bwd as jbwd  # noqa: E402
from repro.kernels.sliding_conv1d import apply_activation as japply  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sliding_conv1d as tsc  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as tbwd  # noqa: E402

# float32: only accumulation-order noise (tests/test_grads.py TOL)
TOL = dict(rtol=2e-5, atol=2e-5)


def _close_scaled(got, want, rtol, atol_frac):
    """allclose with atol proportional to the gradient's magnitude
    (tests/test_grads.py)."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_frac * scale)


def _epi(y, b, act):
    yf = y.astype(jnp.float32)
    if b is not None:
        yf = yf + b.astype(jnp.float32)
    return japply(yf, act).astype(y.dtype)


def _t(a, requires_grad=True):
    return torch.from_numpy(np.asarray(a)).requires_grad_(requires_grad)


def _port_grads(x, w, b, ct, **kw):
    xt, wt, ct_t = _t(x), _t(w), torch.from_numpy(ct)
    bt = None if b is None else _t(b)
    y = tops.conv1d(xt, wt, bias=bt, backend="sliding_pallas", **kw)
    assert y.grad_fn is not None and "Conv1dSliding" in type(y.grad_fn).__name__
    leaves = [t for t in (xt, wt, bt) if t is not None]
    return [g.numpy() for g in torch.autograd.grad((y * ct_t).sum(), leaves)]


@pytest.mark.parametrize(
    "K,stride,act",
    [(3, 1, "gelu"), (5, 1, "relu"), (7, 2, "silu"), (20, 1, "none"),
     (3, 2, "none"), (9, 3, "gelu")],
)
def test_conv1d_grad_regimes(K, stride, act):
    """Grads of (x, w, bias) against jax.grad of the oracle + unfused
    epilogue, at the reference test's regimes."""
    rng = np.random.default_rng(K * 10 + stride)
    x = rng.normal(size=(2, 100, 8)).astype(np.float32)
    w = rng.normal(size=(K, 8, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    ct = rng.normal(size=(2, (100 - K) // stride + 1, 16)).astype(np.float32)

    def f_ref(x, w, b):
        return jnp.sum(_epi(jref.conv1d_ref(x, w, stride=stride), b, act) * ct)

    want = jax.grad(f_ref, (0, 1, 2))(x, w, b)
    got = _port_grads(x, w, b, ct, stride=stride, activation=act)
    for g, r, name in zip(got, want, "xwb"):
        np.testing.assert_allclose(g, np.asarray(r), err_msg=f"d{name}", **TOL)


def test_conv1d_grad_same_padding():
    """SAME padding: the pad's backward (autograd's) composes with the
    Function's."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 60, 8)).astype(np.float32)
    w = rng.normal(size=(5, 8, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    ct = rng.normal(size=(1, 60, 8)).astype(np.float32)

    def f_ref(x, w, b):
        y = jref.conv1d_ref(jnp.pad(x, ((0, 0), (2, 2), (0, 0))), w)
        return jnp.sum(_epi(y, b, "gelu") * ct)

    want = jax.grad(f_ref, (0, 1, 2))(x, w, b)
    got = _port_grads(x, w, b, ct, padding="SAME", activation="gelu")
    for g, r, name in zip(got, want, "xwb"):
        np.testing.assert_allclose(g, np.asarray(r), err_msg=f"d{name}", **TOL)


def test_conv1d_grad_no_bias():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 50, 4)).astype(np.float32)
    w = rng.normal(size=(3, 4, 4)).astype(np.float32)
    ct = rng.normal(size=(1, 48, 4)).astype(np.float32)
    f_ref = lambda x, w: jnp.sum(_epi(jref.conv1d_ref(x, w), None, "silu") * ct)
    want = jax.grad(f_ref, (0, 1))(x, w)
    got = _port_grads(x, w, None, ct, activation="silu")
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)


def test_conv1d_grad_bf16():
    """bf16 operands: grads come back in bf16, within the reference test's
    scaled tolerance."""
    rng = np.random.default_rng(3)
    x, w, b, ct = (jnp.asarray(rng.normal(size=s)).astype(jnp.bfloat16)
                   for s in ((2, 100, 16), (3, 16, 16), (16,), (2, 98, 16)))
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    for act in ("gelu", "none"):
        def f_ref(x, w, b):
            return jnp.sum((_epi(jref.conv1d_ref(x, w), b, act) * ct)
                           .astype(jnp.float32))

        want = jax.grad(f_ref, (0, 1, 2))(x, w, b)
        xt, wt, bt = (bf(a).requires_grad_(True) for a in (x, w, b))
        y = tops.conv1d(xt, wt, bias=bt, activation=act, backend="sliding_pallas")
        got = torch.autograd.grad((y * bf(ct)).float().sum(), (xt, wt, bt))
        for g, r in zip(got, want):
            assert g.dtype == torch.bfloat16
            _close_scaled(g.float().numpy(), r, rtol=5e-2, atol_frac=5e-2)


@pytest.mark.parametrize("K,stride", [(1, 1), (3, 2), (5, 3), (20, 1)])
def test_dw_plain_matches_reference_vjp(K, stride):
    """dw/db of the wrapper (plain version on the CPU) against the
    reference oracle's VJP in w and the sum of dz, float32 and bfloat16
    operands."""
    rng = np.random.default_rng(K + stride)
    for dtype in ("float32", "bfloat16"):
        x = jnp.asarray(rng.normal(size=(3, 70, 6))).astype(dtype)
        w = jnp.zeros((K, 6, 5), jnp.float32)
        n = (70 - K) // stride + 1
        dz = jnp.asarray(rng.normal(size=(3, n, 5))).astype(dtype)
        _, vjp = jax.vjp(
            lambda w: jref.conv1d_ref(x.astype(jnp.float32), w, stride=stride), w)
        want = np.asarray(vjp(dz.astype(jnp.float32))[0])
        tx = torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))
        tdz = torch.from_numpy(np.array(dz, np.float32)).to(getattr(torch, dtype))
        dw, db = tbwd.conv1d_bwd_dw(tx, tdz, K, stride=stride, has_bias=True)
        assert dw.dtype == db.dtype == torch.float32
        _close_scaled(dw.numpy(), want, rtol=1e-5, atol_frac=1e-5)
        _close_scaled(db.numpy(), np.asarray(dz, np.float32).sum((0, 1)),
                      rtol=1e-5, atol_frac=1e-5)
        assert tbwd.conv1d_bwd_dw(tx, tdz, K, stride=stride)[1] is None


def test_act_bwd_matches_reference():
    rng = np.random.default_rng(4)
    z = np.concatenate([np.linspace(-6, 6, 101), [0.0]]).astype(np.float32)
    dy = rng.normal(size=z.shape).astype(np.float32)
    for act in ("relu", "gelu", "silu", "none"):
        want = np.asarray(jbwd.act_bwd(jnp.asarray(dy), jnp.asarray(z), act))
        got = tbwd.act_bwd(torch.from_numpy(dy), torch.from_numpy(z), act).numpy()
        # atol: XLA's and torch's float32 tanh differ in the last bits of
        # the tails, where gelu' takes 1 + tanh(u) ~ 0 and the rounding shows
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5, err_msg=act)
    with pytest.raises(ValueError, match="needs the saved preact"):
        tbwd.act_bwd(torch.ones(3), None, "gelu")


def test_dx_operands_match_reference():
    """The dilated, padded gradient and the flipped weights equal the
    reference's; dx through the forward conv, fitted to a forward input
    with rows it never read, equals the reference's too."""
    for K, stride in ((1, 1), (3, 1), (3, 2), (5, 3)):
        rng = np.random.default_rng(K * stride)
        dz = rng.normal(size=(2, 9, 4)).astype(np.float32)
        w = rng.normal(size=(K, 3, 4)).astype(np.float32)
        jdzp, jwt = jbwd.conv1d_dx_operands(jnp.asarray(dz), jnp.asarray(w),
                                            stride=stride)
        dzp, wt = tbwd.conv1d_dx_operands(torch.from_numpy(dz),
                                          torch.from_numpy(w), stride=stride)
        np.testing.assert_array_equal(dzp.numpy(), np.asarray(jdzp))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(jwt))
        L = (9 - 1) * stride + K + stride - 1  # rows the forward never read
        dx = tbwd.conv1d_dx(torch.from_numpy(dz), torch.from_numpy(w),
                            stride=stride, L=L)
        jdx = jbwd._fit_len(jref.conv1d_ref(jdzp, jwt), L)
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)


def test_save_preact_is_the_post_bias_sum():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 40, 5)).astype(np.float32)
    w = rng.normal(size=(3, 5, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    pre = np.asarray(jref.conv1d_ref(x, w, stride=2)) + b
    y, z = tsc.conv1d_sliding(*map(torch.from_numpy, (x, w, b)), stride=2,
                              activation="silu", save_preact=True)
    np.testing.assert_allclose(z.numpy(), pre, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(japply(jnp.asarray(pre), "silu")),
                               rtol=3e-4, atol=3e-4)
    assert z.dtype == y.dtype == torch.float32


def test_function_skips_grads_nobody_asked_for(monkeypatch):
    """The mels need no gradient: conv1 runs no dx conv; without a bias
    the Function returns no db."""
    calls = []
    real = tbwd.conv1d_dx
    monkeypatch.setattr(tbwd, "conv1d_dx",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    mels = torch.randn(2, 16, 80)
    w = torch.randn(3, 80, 8, requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    y = tops.conv1d(mels, w, bias=b, activation="gelu", padding="SAME")
    gw, gb = torch.autograd.grad(y.sum(), (w, b))
    assert not calls and gw.shape == w.shape and gb.shape == b.shape
    x = torch.randn(2, 16, 8, requires_grad=True)
    (gx,) = torch.autograd.grad(tops.conv1d(x, w.detach()[:, :8]).sum(), (x,))
    assert calls and gx.shape == x.shape


def test_no_grad_and_other_backends_skip_the_function():
    """Serving (no grad wanted) calls the kernel without a residual; the
    ``sliding`` backend differentiates by plain autograd."""
    x = torch.randn(1, 20, 4)
    w = torch.randn(3, 4, 4, requires_grad=True)
    with torch.no_grad():
        assert tops.conv1d(x, w, activation="gelu").grad_fn is None
    assert tops.conv1d(x, w.detach(), activation="gelu").grad_fn is None
    y = tops.conv1d(x, w, activation="gelu", backend="sliding")
    assert "Conv1dSliding" not in type(y.grad_fn).__name__


def test_dw_wrapper_refuses_other_devices_and_counts_no_cpu_launch():
    with pytest.raises(ValueError, match="no conv1d_bwd_dw for device"):
        tbwd.conv1d_bwd_dw(torch.empty((1, 8, 4), device="meta"),
                           torch.empty((1, 6, 2), device="meta"), 3)
    with pytest.raises(ValueError, match="reads past"):
        tbwd.conv1d_bwd_dw(torch.zeros(1, 8, 4), torch.zeros(1, 7, 2), 3)
    before = tbwd.conv1d_bwd_dw.launches
    tbwd.conv1d_bwd_dw(torch.zeros(1, 8, 4), torch.zeros(1, 6, 2), 3)
    assert tbwd.conv1d_bwd_dw.launches == before
