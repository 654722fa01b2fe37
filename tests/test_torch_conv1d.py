"""Sliding conv1d of the PyTorch port against the JAX reference, on the CPU.

The same numpy inputs go through the reference's sliding conv
(``repro.core.conv.conv1d_sliding`` + ``repro.kernels.ops.epilogue_unfused``,
and the ``repro.kernels.ref.conv1d_ref`` oracle) and through the port's
``ops.conv1d`` (whose ``sliding_pallas`` backend runs the CUDA kernel's
plain version on a CPU tensor) and the kernel's ``conv1d_sliding_plain``.
The reference's Pallas conv kernels are not used: they fail at trace under
the jax in this container.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import conv as jconv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.sliding_conv1d import apply_activation as japply  # noqa: E402
from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sliding_conv1d as tsc  # noqa: E402

# float32: the sums run in another order than the reference's (the
# tolerance of tests/test_kernels.py); bfloat16 compared in float32
TOL = dict(rtol=3e-4, atol=3e-4)
BTOL = dict(rtol=5e-2, atol=5e-2)
ACTS = ("none", "relu", "gelu", "silu")


def _inputs(seed, B=2, L=37, Cin=5, Cout=6, K=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, Cin)).astype(np.float32)
    w = rng.normal(size=(K, Cin, Cout)).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    return x, w, b


@functools.partial(jax.jit, static_argnames=("stride", "padding", "activation"))
def _reference_jit(x, w, b, *, stride, padding, activation):
    y = jconv.conv1d_sliding(x, w, stride=stride, padding=padding)
    return jops.epilogue_unfused(y, b, activation)


def _reference(x, w, b, *, stride, padding, activation):
    """The reference's sliding conv + unfused epilogue, compiled once per
    shape (op-by-op dispatch of the unrolled tap loop is slower)."""
    return np.asarray(_reference_jit(x, w, b, stride=stride, padding=padding,
                                     activation=activation))


@pytest.mark.parametrize("padding", ["SAME", "VALID", "CAUSAL"])
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("K", [1, 3, 5, 7, 18])
def test_ops_conv1d_matches_reference(K, stride, padding):
    act = ACTS[(K + stride) % len(ACTS)]
    x, w, b = _inputs(K * 10 + stride, L=40, K=K)
    want = _reference(x, w, b, stride=stride, padding=padding, activation=act)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    for backend in ("sliding_pallas", "sliding", "xla"):
        got = tops.conv1d(xt, wt, stride=stride, padding=padding,
                          backend=backend, bias=bt, activation=act)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=backend)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("K,stride", [(1, 1), (3, 1), (3, 2), (7, 3), (18, 2)])
def test_plain_kernel_matches_oracle(K, stride, act):
    """The kernel's plain version on VALID input against the reference
    oracle plus the unfused epilogue."""
    x, w, b = _inputs(K + 7 * stride, L=45, Cin=8, Cout=16, K=K)
    y = jax.jit(jref.conv1d_ref, static_argnames="stride")(x, w, stride=stride)
    want = np.asarray(jops.epilogue_unfused(y, jnp.asarray(b), act))
    got = tsc.conv1d_sliding_plain(
        *map(torch.from_numpy, (x, w, b)), stride=stride, activation=act
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_kernel_without_bias_is_the_bare_conv():
    x, w, _ = _inputs(3, K=5)
    want = np.asarray(jref.conv1d_ref(jnp.asarray(x), jnp.asarray(w), stride=2))
    got = tsc.conv1d_sliding(torch.from_numpy(x), torch.from_numpy(w), stride=2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("act", ["none", "gelu"])
def test_bf16_operands(act):
    """bf16 x and w, float32 sums, output in bf16 (the reference's contract),
    compared in float32."""
    x, w, b = _inputs(11, L=64, Cin=16, Cout=8, K=3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    y = jconv.conv1d_sliding(xb, wb, stride=2, padding="SAME")
    want = np.asarray(jops.epilogue_unfused(y, jnp.asarray(b), act), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    got = tops.conv1d(xt, wt, stride=2, padding="SAME",
                      backend="sliding_pallas", bias=torch.from_numpy(b),
                      activation=act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BTOL)


@pytest.mark.parametrize("act", ACTS)
def test_apply_activation_matches_reference(act):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    want = np.asarray(japply(jnp.asarray(x), act))
    got = tsc.apply_activation(torch.from_numpy(x), act).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("padding", ["SAME", "VALID", "CAUSAL", (2, 1)])
@pytest.mark.parametrize("K", [1, 2, 3, 18])
def test_padding_and_regime_match_reference(K, padding):
    assert tconv._resolve_pad_1d(padding, K, 1) == jconv._resolve_pad_1d(padding, K, 1)
    assert tconv.regime_for(K) == jconv.regime_for(K)
    lo, hi = tconv._resolve_pad_1d(padding, K, 1)
    assert tconv._out_len(40, K, 2, 1, lo, hi) == jconv._out_len(40, K, 2, 1, lo, hi)


def test_wrapper_refuses_other_devices_and_bad_shapes():
    x = torch.empty((1, 8, 4), device="meta")
    w = torch.empty((3, 4, 2), device="meta")
    with pytest.raises(ValueError, match="no sliding_conv1d for device"):
        tsc.conv1d_sliding(x, w)
    with pytest.raises(ValueError, match="exceeds input length"):
        tsc.conv1d_sliding(torch.zeros(1, 2, 4), torch.zeros(3, 4, 2))
    with pytest.raises(ValueError, match="unknown activation"):
        tsc.conv1d_sliding(torch.zeros(1, 8, 4), torch.zeros(3, 4, 2),
                           activation="tanh")


def test_cpu_calls_do_not_count_as_launches():
    before = tsc.conv1d_sliding.launches
    x, w, b = _inputs(5)
    tsc.conv1d_sliding(*map(torch.from_numpy, (x, w, b)), activation="gelu")
    assert tsc.conv1d_sliding.launches == before
