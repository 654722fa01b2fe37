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
    """A block's output rows: the paper's shape (1, 16384, 32) takes 32 (512
    blocks: about four an SM of 132), the wide (8, 16384, 1024) and the
    one-channel (8, 16384, 1) 256, (1, 4096, 32) 8; as few as one where
    the outputs cannot fill the card."""
    def rows(B, n, C, w=16):
        return tsp.pool_layout(B, n, C, w, "sum", 4).rows

    assert rows(1, 16384, 32) == 32
    assert rows(8, 16384, 1024) == 256
    assert rows(8, 16384, 1) == 256
    assert rows(4, 16384, 64) == 256
    assert rows(1, 4096, 32) == 8
    assert rows(1, 5, 4, 3) == 1  # too few outputs to fill the card


# the layout's shapes: (B, L, C) and windows: the paper's and phase 39's,
# the wide one, the one-channel layout of benchmarks/table_conv1d.py, the
# restored bf16 edge, phase 36's edges, and windows that stream
LAYOUT_SHAPES = [((1, 16384, 32), (4, 16, 64, 256)), ((8, 16384, 1024), (16,)),
                 ((8, 16384, 1), (16, 64)), ((8, 2000, 1024), (200,)),
                 ((2, 300, 37), (1, 5, 300)), ((1, 300, 8), (100, 256)),
                 ((3, 5000, 64), (33,)), ((8, 3000, 1024), (300,)),
                 ((2, 3000, 37), (2000,)), ((3, 70011, 1), (60000,)),
                 ((1, 16384, 32), (16384,))]


@pytest.mark.parametrize("sms", [8, 132])
@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("form", tsp.FORMS)
@pytest.mark.parametrize("shape,windows", LAYOUT_SHAPES,
                         ids=[str(s) for s, _ in LAYOUT_SHAPES])
def test_pool_layout(shape, windows, form, elem, sms):
    """Every layout the kernel's C entry takes: channels a power of two up
    to 32 (lanes) and 256 threads in whole groups; the block's shared
    memory within ``POOL_SMEM``; the halo in one stage, or streamed in
    stages (the sum's a whole number of runs, one a thread group; the
    scan's block no longer than the window); at the paper's shape at
    least two blocks an SM."""
    B, L, C = shape
    for w in windows:
        n = L - w + 1
        lay = tsp.pool_layout(B, n, C, w, form, elem, sms)
        assert lay.chans & (lay.chans - 1) == 0 and lay.chans <= 32
        assert lay.chans >= min(C, 32) and lay.groups * lay.chans == 256
        assert 1 <= lay.rows <= min(n, tsp.MAX_ROWS) and lay.run >= 1
        assert tsp.pool_smem_bytes(form, elem, lay.rows, lay.chans, lay.piece,
                                   w) <= tsp.POOL_SMEM
        halo = lay.rows + w - 1
        if lay.streamed(w):
            assert lay.piece >= 1
            if form == "sum":
                assert lay.piece == lay.run * lay.groups
            if form == "max_scan":
                assert lay.rows <= w
        else:
            assert lay.piece == halo
            if form == "sum":
                assert -(-halo // lay.run) <= lay.groups
        blocks = B * -(-n // lay.rows) * -(-C // lay.chans)
        if shape == (1, 16384, 32) and w <= 256:
            assert blocks >= 2 * sms
        if w >= 2000:  # the card tests' and phase 36's streamed halos
            assert lay.streamed(w)


def _bf16(a):
    return np.asarray(a, dtype=np.float32).astype(BF16)


def kernel_sum(x, window, lay, avg):
    """``pool_sum_kernel`` transcribed in numpy float32: per block of
    ``lay.rows`` outputs, its halo in stages of ``lay.piece`` rows; in each
    stage the runs of ``lay.run`` rows summed in sequence, the carry into
    each run the totals before it added in run order to the carry of the
    earlier stages, S[i-1] kept for later stages; y = S[i+w-1] - S[i-1]
    cast to x's type, avg divided by w in float32 and cast again."""
    B, L, C = x.shape
    n_out = L - window + 1
    R, Q, P = lay.rows, lay.run, lay.piece
    H = R + window - 1
    xf = np.asarray(x, dtype=np.float32)
    y = np.zeros((B, n_out, C), np.float32)
    for b in range(B):
        for r0 in range(0, n_out, R):
            nout = min(R, n_out - r0)
            halo = np.zeros((H, C), np.float32)
            top = min(L, r0 + H)
            halo[: top - r0] = xf[b, r0:top]
            carry = np.zeros(C, np.float32)
            lo = np.zeros((R, C), np.float32)
            for p0 in range(0, H, P):
                n = min(P, H - p0)
                st = halo[p0 : p0 + n]
                S = np.zeros_like(st)
                nrun = -(-n // Q)
                tot = np.zeros((nrun, C), np.float32)
                for g in range(nrun):
                    acc = np.zeros(C, np.float32)
                    for j in range(g * Q, min(g * Q + Q, n)):
                        acc = acc + st[j]
                        S[j] = acc
                    tot[g] = acc
                for g in range(nrun):
                    cq = carry.copy()
                    for r in range(g):
                        cq = cq + tot[r]
                    S[g * Q : g * Q + Q] = cq + S[g * Q : g * Q + Q]
                for r in range(nrun):
                    carry = carry + tot[r]
                for h in range(p0, min(p0 + n, R - 1)):
                    lo[h + 1] = S[h - p0]
                for i in range(max(0, p0 - window + 1),
                               min(nout, p0 + n - window + 1)):
                    l = i - 1 - p0
                    s_lo = (np.zeros(C, np.float32) if i == 0
                            else S[l] if l >= 0 else lo[i])
                    y[b, r0 + i] = S[i + window - 1 - p0] - s_lo
    if x.dtype == np.float32:
        return (y / np.float32(window)).astype(np.float32) if avg else y
    y = _bf16(y)
    return _bf16(y.astype(np.float32) / np.float32(window)) if avg else y


# (B, L, C, w, dtype, layout): the plan's layout, then ones forced to
# stream (stages of a few runs) and to cut the halo into many runs
EMULATED = [(2, 300, 5, 7, "float32", None),
            (1, 600, 8, 200, "bfloat16", None),
            (2, 150, 3, 9, "bfloat16", None), (3, 77, 1, 77, "float32", None),
            (2, 300, 37, 20, "float32", tsp.PoolLayout(16, 32, 5, 40)),
            (1, 600, 8, 200, "bfloat16", tsp.PoolLayout(24, 8, 7, 224)),
            (2, 500, 1, 300, "float32", tsp.PoolLayout(32, 1, 3, 768)),
            (1, 700, 4, 450, "float32", tsp.PoolLayout(64, 4, 9, 9 * 64))]


@pytest.mark.parametrize("op", ["sum", "avg"])
@pytest.mark.parametrize("B,L,C,window,dtype,layout", EMULATED)
def test_plain_sum_is_the_kernels_order(B, L, C, window, dtype, layout, op):
    """The plain version's sum and avg equal, bit for bit, the kernel's
    float32 order transcribed in numpy (stages included: the carry across
    them is the runs' order), and so does the sum gradient (the forward on
    dy padded by w - 1 zero rows); the layout the plain version takes is
    the kernel's (on the CPU, an H100's)."""
    rng = np.random.default_rng(L + C + window)
    xn = rng.normal(size=(B, L, C)).astype(np.float32) * 3
    x = torch.from_numpy(xn).to(getattr(torch, dtype))
    xe = xn if dtype == "float32" else _bf16(xn)
    lay = layout or tsp.pool_layout(B, L - window + 1, C, window, "sum",
                                    x.element_size())
    got = tsp.sliding_pool_plain(x, window=window, op=op, tile=lay.rows,
                                 run=lay.run)
    want = kernel_sum(xe, window, lay, op == "avg")
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    if layout is None:
        assert torch.equal(got, tsp.sliding_pool_plain(x, window=window,
                                                       op=op))
        if op == "sum":
            dy = x[:, : L - window + 1]
            pad = np.pad(np.asarray(xe)[:, : L - window + 1],
                         ((0, 0), (window - 1, window - 1), (0, 0)))
            lb = tsp.pool_layout(B, L, C, window, "sum", x.element_size())
            np.testing.assert_array_equal(
                tsp.sum_pool_bwd_plain(dy, window=window).float().numpy(),
                np.asarray(kernel_sum(pad, window, lb, False), np.float32))


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


@pytest.mark.parametrize("symbol,argtypes", [
    ("sliding_pool", tsp._POOL_ARGTYPES), ("max_pool_bwd", tsp._BWD_ARGTYPES)])
def test_entry_argtypes_match_the_c_signatures(symbol, argtypes):
    """The ctypes argument lists name as many arguments, pointers where
    the C entry takes pointers, as ``csrc/sliding_pool.cu`` declares."""
    text = (tsp.build.CSRC / "sliding_pool.cu").read_text()
    sig = text[text.index(f'extern "C" int {symbol}('):]
    params = [p.strip() for p in sig[sig.index("(") + 1 : sig.index(")")]
              .split(",")]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is tsp.ctypes.c_void_p), p
