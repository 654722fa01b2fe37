"""Sliding-window pooling of the PyTorch port against the JAX reference, on
the CPU.

The same numpy inputs go through both packages: ``ops.pool1d`` forward
against the
reference's ``ops.pool1d`` (which serves ``ref.pool_ref`` in this
container, its Pallas rung failing at trace); the gradients through
``ops.Pool1d`` against ``jax.grad`` of the reference on tie-free inputs;
at tied maxima, against a numpy transcription of the reference's kernel
bodies ``_max_pool_count_kernel`` and ``_max_pool_bwd_kernel`` (the
reference's autodiff of ``sliding_max`` splits ties otherwise); the
max-pool method heuristic and the shape key. On the CPU the wrappers run
the kernels' plain versions; the kernels themselves are held to those on
the card by ``tests/test_torch_pool_card.py``; ``core/sliding.py`` is held
to the reference by ``tests/test_torch_sliding.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import sliding as tsl  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sliding_pool as tsp  # noqa: E402

# the reference's pooling tolerance (tests/test_kernels.py, test_grads.py
# PTOL): the two-phase prefix scan trades exact associativity for O(n)
PTOL = dict(rtol=2e-4, atol=2e-4)
BF16 = jnp.bfloat16  # a numpy dtype too (ml_dtypes)


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close_scaled(got, want, rtol, atol_frac):
    """tests/test_grads.py ``_close_scaled``: atol proportional to the
    largest |want| (bfloat16 sums reach far above 1)."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_frac * scale)


def _both(x, dtype):
    """x as the reference's and the port's array of ``dtype``."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


# -- ops.pool1d forward -----------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "avg", "max"])
@pytest.mark.parametrize("window", [2, 9, 64])
def test_pool1d_matches_reference(op, window):
    x = _normal(window, (2, 200, 16))
    want = jops.pool1d(jnp.asarray(x), window=window, op=op, interpret=True)
    got = tops.pool1d(torch.from_numpy(x), window=window, op=op)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PTOL)


@pytest.mark.parametrize("window", [100, 256])
def test_max_pool1d_large_window_matches_reference(window):
    """Windows larger than a tile: both forms exact."""
    x = _normal(window, (1, 300, 8))
    want = np.asarray(jops.pool1d(jnp.asarray(x), window=window, op="max",
                                  interpret=True))
    for method in ("scan", "shift"):
        got = tops.pool1d(torch.from_numpy(x), window=window, op="max",
                          method=method)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [1, 4, 48, 256, 300])
def test_max_pool_methods_agree_exactly(window, dtype):
    x = torch.from_numpy(_normal(5, (2, 300, 8))).to(getattr(torch, dtype))
    a = tops.pool1d(x, window=window, op="max", method="scan")
    b = tops.pool1d(x, window=window, op="max", method="shift")
    assert a.dtype == x.dtype
    assert torch.equal(a, b)
    assert torch.equal(a, tsl.sliding_max(x, window, axis=1))


@pytest.mark.parametrize("tile", [1, 3, 32, 512])
@pytest.mark.parametrize("op", ["sum", "avg", "max"])
def test_plain_pool_tiles_agree(op, tile):
    """The plain version walks the kernel's tiles; the tile changes only
    the sum's rounding, never the max."""
    x = torch.from_numpy(_normal(tile, (2, 150, 3)))
    got = tsp.sliding_pool_plain(x, window=7, op=op, tile=tile)
    want = tsl.pool_ref(x, window=7, op=op)
    if op == "max":
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **PTOL)


def test_pool_tile_rule():
    """Small shapes walk 32 rows; wide ones grow the tile to keep about
    132·1024 threads; a tile never exceeds the rows."""
    assert tsp.pool_tile(1, 16384, 32) == 32
    assert tsp.pool_tile(8, 16384, 1024) == 1024
    assert tsp.pool_tile(8, 16384, 1) == 32
    assert tsp.pool_tile(4, 16384, 64) == 32
    assert tsp.pool_tile(16, 16384, 64) == 128
    assert tsp.pool_tile(1, 5, 4) == 5


# -- gradients --------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "avg", "max"])
@pytest.mark.parametrize("window", [2, 9, 64])
def test_pool1d_grad_matches_reference(op, window):
    """tests/test_grads.py::test_pool_grad: tie-free normals."""
    x = _normal(window + 100, (2, 200, 16))
    want = jax.grad(lambda z: jnp.sum(
        jref.pool_ref(z, window=window, op=op) ** 2))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = tops.pool1d(xt, window=window, op=op)
    assert type(y.grad_fn).__name__ == "Pool1dBackward"
    (y ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **PTOL)


def test_pool1d_grad_bf16_max_matches_reference():
    """tests/test_grads.py::test_pool_grad_bf16_max: tie-free bf16 data
    (per-channel integer permutations, exact in bf16)."""
    rng = np.random.default_rng(0)
    cols = np.stack([rng.permutation(100) for _ in range(8)], axis=1)
    x = (cols[None].astype(np.float32) * 0.25)
    jx, tx = _both(x, "bfloat16")
    want = jax.grad(lambda z: jnp.sum(
        jref.pool_ref(z, window=9, op="max").astype(jnp.float32) ** 2))(jx)
    tx.requires_grad_()
    (tops.pool1d(tx, window=9, op="max").float() ** 2).sum().backward()
    assert tx.grad.dtype == torch.bfloat16
    _close_scaled(tx.grad.float().numpy(), np.asarray(want.astype(jnp.float32)),
                  rtol=5e-2, atol_frac=5e-2)


@pytest.mark.parametrize("op", ["sum", "avg"])
def test_pool1d_grad_bf16_sum_avg_matches_reference(op):
    jx, tx = _both(_normal(4, (2, 60, 8)), "bfloat16")
    want = jax.grad(lambda z: jnp.sum(
        jref.pool_ref(z, window=5, op=op).astype(jnp.float32) ** 2))(jx)
    tx.requires_grad_()
    (tops.pool1d(tx, window=5, op=op).float() ** 2).sum().backward()
    assert tx.grad.dtype == torch.bfloat16
    _close_scaled(tx.grad.float().numpy(), np.asarray(want.astype(jnp.float32)),
                  rtol=5e-2, atol_frac=5e-2)


def _max_bwd_numpy(x, y, dy, window):
    """A transcription of the reference's max-pool gradient, tile-free:
    ``_max_pool_count_kernel`` (cnt, float32), the split dy / max(cnt, 1)
    rounded to dy's type, then ``_max_pool_bwd_kernel``'s shift-and-select
    against zero-padded y and dy (k = 0 .. w-1, float32 sums), one cast to
    x's type."""
    B, L, C = x.shape
    out_len = y.shape[1]
    cnt = np.zeros(y.shape, np.float32)
    for m in range(window):
        cnt += (x[:, m : m + out_len] == y).astype(np.float32)
    dys = (dy.astype(np.float32) / np.maximum(cnt, 1.0)).astype(dy.dtype)
    pad = ((0, 0), (window - 1, L - out_len), (0, 0))
    yp, dyp = np.pad(y, pad), np.pad(dys, pad)
    acc = np.zeros(x.shape, np.float32)
    for k in range(window):
        off = window - 1 - k
        acc += np.where(x == yp[:, off : off + L],
                        dyp[:, off : off + L].astype(np.float32), 0.0)
    return acc.astype(x.dtype)


def _port_max_grad(x, window, dy=None):
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16 if x.dtype == BF16 else torch.float32)
    xt.requires_grad_()
    y = tops.pool1d(xt, window=window, op="max")
    y.backward(torch.ones_like(y) if dy is None else dy)
    return y.detach(), xt.grad


def test_max_grad_at_ties_follows_the_kernel_bodies():
    """x = 0, w = 3: each window's mass is split over its three ties,
    [1/3, 2/3, 1, 1, 2/3, 1/3] (the reference served here by autodiff gives
    [0.375, 0.5, 1.125, 1.125, 0.5, 0.375]; both sum to 4)."""
    x = np.zeros((1, 6, 1), np.float32)
    y, g = _port_max_grad(x, 3)
    want = _max_bwd_numpy(x, y.numpy(), np.ones((1, 4, 1), np.float32), 3)
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(g.numpy().ravel(),
                               [1 / 3, 2 / 3, 1, 1, 2 / 3, 1 / 3], atol=1e-6)
    assert abs(float(g.sum()) - 4.0) < 1e-6  # 4 windows × mass 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [2, 9, 33])
def test_max_grad_post_relu_matches_the_kernel_bodies(window, dtype):
    """Post-relu normals tie at 0 in most windows: the port against the
    numpy transcription, with a random cotangent (bfloat16: the split is
    rounded to bf16 before the scatter, as in the reference)."""
    rng = np.random.default_rng(window)
    x = np.maximum(rng.normal(size=(2, 100, 8)), 0).astype(np.float32)
    dy = rng.normal(size=(2, 100 - window + 1, 8)).astype(np.float32)
    if dtype == "bfloat16":
        x, dy = x.astype(BF16), dy.astype(BF16)
    y, g = _port_max_grad(x, window, torch.from_numpy(
        np.asarray(dy, np.float32)).to(getattr(torch, dtype)))
    y_np = np.asarray(y.float().numpy()).astype(x.dtype)
    want = _max_bwd_numpy(x, y_np, dy, window)
    np.testing.assert_allclose(g.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-6, atol=1e-6)


def test_max_grad_at_ties_conserves_mass():
    """tests/test_grads.py::test_pool_grad_max_ties_conserve_mass: Σdx =
    number of windows × Σdy per channel."""
    rng = np.random.default_rng(1)
    x = np.maximum(rng.normal(size=(2, 100, 8)), 0).astype(np.float32)
    _, g = _port_max_grad(x, 9)
    assert abs(float(g.sum()) - 2 * 92 * 8) < 1e-3
    np.testing.assert_allclose(g.sum(dim=(0, 1)).numpy(), 2 * 92, atol=1e-4)


def test_sum_pool_bwd_is_the_transposed_sum():
    """sum_pool_bwd(dy) equals autograd of the plain sum's adjoint."""
    x = torch.from_numpy(_normal(2, (2, 50, 3))).requires_grad_()
    dy = torch.from_numpy(_normal(3, (2, 44, 3)))
    tsl.sliding_sum_shift(x, 7, axis=1).backward(dy)
    np.testing.assert_allclose(tsp.sum_pool_bwd(dy, window=7).numpy(),
                               x.grad.numpy(), **PTOL)


# -- dispatch ---------------------------------------------------------------

def test_pool_method_heuristic_matches_reference_untuned(tmp_path,
                                                         monkeypatch):
    """explicit → (the reference's tuned cache, empty here) → heuristic:
    shift below window 32 for max, else scan; sum/avg always scan."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    jautotune.invalidate()
    x = _normal(0, (1, 64, 4))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert tops.POOL_SHIFT_MAX_WINDOW == jops.POOL_SHIFT_MAX_WINDOW == 32
    for window in (1, 4, 31, 32, 64):
        for op in ("sum", "avg", "max"):
            for explicit in (None, "scan", "shift"):
                assert tops._pool_method(tx, window, op, explicit) == \
                    jops._pool_method(jx, window, op, explicit)
    assert tops._pool_method(tx, 4, "max", None) == "shift"
    assert tops._pool_method(tx, 32, "max", None) == "scan"
    assert tops._pool_method(tx, 4, "sum", None) == "scan"
    jautotune.invalidate()


def test_pool1d_key_and_dispatch_log_match_reference():
    args = (2, 200, 16, 9, "max", "float32")
    assert tautotune.pool1d_key(*args) == jautotune.pool1d_key(*args)
    tops.POOL1D_DISPATCH.clear()
    tops.pool1d(torch.zeros(2, 200, 16), window=9, op="max")
    assert tops.POOL1D_DISPATCH.items() == [(tautotune.pool1d_key(*args),
                                             "plain")]


def test_pool_wrappers_refuse_bad_arguments_and_count_no_cpu_launch():
    x = torch.zeros(1, 10, 2)
    with pytest.raises(ValueError, match="unknown pool op"):
        tops.pool1d(x, window=3, op="min")
    with pytest.raises(ValueError, match="unknown pool method"):
        tops.pool1d(x, window=3, op="max", method="tree")
    with pytest.raises(ValueError, match="exceeds length"):
        tops.pool1d(x, window=11)
    with pytest.raises(ValueError, match="no sliding_pool for device"):
        tsp.sliding_pool(torch.empty((1, 10, 2), device="meta"), window=3)
    with pytest.raises(ValueError, match="no max_pool_bwd for device"):
        tsp.max_pool_bwd(*(torch.empty(s, device="meta") for s in
                           ((1, 10, 2), (1, 8, 2), (1, 8, 2))), window=3)
    with pytest.raises(ValueError, match="not the window-3 pool"):
        tsp.max_pool_bwd(x, torch.zeros(1, 7, 2), torch.zeros(1, 7, 2),
                         window=3)
    counts = (tsp.sliding_pool.launches, tsp.sum_pool_bwd.launches,
              tsp.max_pool_bwd.launches)
    xg = x.clone().requires_grad_()
    tops.pool1d(xg, window=3, op="max").sum().backward()
    tops.pool1d(xg, window=3, op="avg").sum().backward()
    assert (tsp.sliding_pool.launches, tsp.sum_pool_bwd.launches,
            tsp.max_pool_bwd.launches) == counts
