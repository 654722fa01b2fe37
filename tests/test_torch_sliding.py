"""``core/sliding.py`` of the PyTorch port against the JAX reference's
``repro.core.sliding``, on the CPU: every function (the sliding sums by
scan and by shift, the block-decomposed sliding max/min and the generic
``sliding_reduce``, the shift max, the average, ``_extreme``, the NHWC
``max_pool2d`` / ``avg_pool2d``) and ``pool_ref``, the oracle of
``ops.pool1d``, on the same numpy inputs: axes 1 and -1, float32 and
bfloat16, int8 codes for the extremes, the edge-CNN example's shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import sliding as jsl  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import sliding as tsl  # noqa: E402

# the reference's pooling tolerance (tests/test_kernels.py): the two-phase
# prefix scan trades exact associativity for O(n)
PTOL = dict(rtol=2e-4, atol=2e-4)


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close_scaled(got, want, rtol, atol_frac):
    """tests/test_grads.py ``_close_scaled``: atol proportional to the
    largest |want|."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_frac * scale)


def _both(x, dtype):
    """x as the reference's and the port's array of ``dtype``."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# -- core/sliding.py --------------------------------------------------------

SLIDING_FNS = ("sliding_sum_scan", "sliding_sum_shift", "sliding_max",
               "sliding_max_shift", "sliding_min", "sliding_avg")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [1, -1])
@pytest.mark.parametrize("window", [1, 4, 12])
@pytest.mark.parametrize("name", SLIDING_FNS)
def test_sliding_functions_match_reference(name, window, axis, dtype):
    """Windows 1 and n (12) included."""
    x = _normal(window, (3, 12, 12))
    jx, tx = _both(x, dtype)
    want = getattr(jsl, name)(jx, window, axis=axis)
    got = getattr(tsl, name)(tx, window, axis=axis)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, **PTOL)
    else:
        _close_scaled(_np(got), want, rtol=5e-2, atol_frac=5e-2)


@pytest.mark.parametrize("name", ["sliding_max", "sliding_min",
                                  "sliding_max_shift"])
@pytest.mark.parametrize("axis", [1, -1])
def test_sliding_extremes_of_int8_codes_are_exact(name, axis):
    """int8 codes pool exactly: the identity pad is the type's bound."""
    x = np.random.default_rng(3).integers(-128, 128, size=(2, 37, 37)).astype(
        np.int8)
    want = getattr(jsl, name)(jnp.asarray(x), 5, axis=axis)
    got = getattr(tsl, name)(torch.from_numpy(x), 5, axis=axis)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype,lo", [("float32", True), ("float32", False),
                                      ("bfloat16", True), ("int8", True),
                                      ("int8", False)])
def test_extreme_matches_reference(dtype, lo):
    want = float(jsl._extreme(jnp.dtype(dtype), lo=lo).astype(jnp.float32))
    assert float(tsl._extreme(getattr(torch, dtype), lo=lo)) == want


@pytest.mark.parametrize("op", ["add", "maximum", "minimum"])
@pytest.mark.parametrize("window", [2, 6, 25])
def test_sliding_reduce_matches_reference(op, window):
    """Any associative op: cummax/cummin for max/min, the log-depth scan
    for the others."""
    x = _normal(window + 1, (2, 25, 3))
    init = {"add": 0.0, "maximum": -np.inf, "minimum": np.inf}[op]
    want = jsl.sliding_reduce(jnp.asarray(x), window, getattr(jnp, op), init,
                              axis=1)
    got = tsl.sliding_reduce(torch.from_numpy(x), window, getattr(torch, op),
                             init, axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PTOL)


@pytest.mark.parametrize("name", SLIDING_FNS)
@pytest.mark.parametrize("window", [0, 11])
def test_sliding_functions_refuse_bad_windows(name, window):
    for fn, x in ((getattr(jsl, name), jnp.zeros((2, 10))),
                  (getattr(tsl, name), torch.zeros(2, 10))):
        with pytest.raises(ValueError):
            fn(x, window)


@pytest.mark.parametrize("window,stride", [((2, 2), None), ((3, 3), (1, 1))])
@pytest.mark.parametrize("name", ["max_pool2d", "avg_pool2d"])
def test_pool2d_matches_reference_at_the_edge_cnn_shape(name, window, stride):
    """The edge-CNN example's feature map, (64, 28, 28, 16) NHWC."""
    x = _normal(7, (64, 28, 28, 16))
    want = getattr(jsl, name)(jnp.asarray(x), window, stride)
    got = getattr(tsl, name)(torch.from_numpy(x), window, stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["sum", "avg", "max"])
def test_pool_ref_matches_reference(op, dtype):
    jx, tx = _both(_normal(11, (2, 70, 5)), dtype)
    want = np.asarray(jref.pool_ref(jx, window=6, op=op).astype(jnp.float32))
    got = _np(tsl.pool_ref(tx, window=6, op=op))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **PTOL)
    else:
        _close_scaled(got, want, rtol=5e-2, atol_frac=5e-2)
