"""The pooling kernels (sliding pool forward, the sum-pool gradient, the
one-launch max-pool gradient) and the selective-scan kernel against their
plain versions, on the card; ``ops.pool1d`` through ``Pool1d`` on the card
against the same call on CPU tensors; ``ops.conv1d(backend="sliding")`` on
the conv kernel.

Needs an NVIDIA card and ``nvcc``; skips without a card. It imports neither
jax nor the JAX package, so it runs where the port runs (``--noconftest``:
the suite's conftest imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_pool_card.py -m cuda
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sliding_conv1d as tsc  # noqa: E402
from repro_torch.kernels import sliding_pool as tsp  # noqa: E402
from repro_torch.kernels import ssm_scan as tss  # noqa: E402


@pytest.fixture
def card():
    """Skip without a card; full float32 (TF32 off) with one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repro_torch

    repro_torch.resolve_device("cuda")
    return "cuda"


def _close(got, want):
    """float32: within 1e-5 of max |want| (the prefix sums run in another
    order); bfloat16: within one bf16 step of the plain value plus 1e-5 of
    max |want|."""
    g, w = got.float(), want.float()
    assert g.shape == w.shape and torch.isfinite(g).all()
    top = w.abs().max().item()
    if got.dtype == torch.float32:
        tol = 1e-5 * max(1.0, top)
    else:
        tol = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30))) - 7
                         ) + 1e-5 * top
    assert ((g - w).abs() <= tol).all(), (g - w).abs().max().item()


def _randn(seed, shape, dev, dtype, relu=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if relu:
        x = np.maximum(x, 0)
    return torch.from_numpy(x).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["sum", "avg", "max_scan", "max_shift"])
@pytest.mark.parametrize("B,L,C,window", [(2, 300, 37, 1), (2, 300, 37, 5),
                                          (1, 300, 8, 100), (1, 300, 8, 256),
                                          (3, 77, 1, 77), (2, 1100, 33, 64)])
def test_pool_kernel_matches_plain(card, B, L, C, window, form, dtype):
    """Row 8: one launch, counted under its form; max exact (and scan equal
    to shift), sum/avg as ``_close``; ragged last tiles, C = 1, w = L."""
    dt = getattr(torch, dtype)
    op, _, method = form.partition("_")
    x = _randn(L + C + window, (B, L, C), card, dt)
    before = (tsp.sliding_pool.launches, getattr(
        tsp.sliding_pool, f"launches_{form}"))
    got = tsp.sliding_pool(x, window=window, op=op, method=method or "scan")
    assert (tsp.sliding_pool.launches, getattr(
        tsp.sliding_pool, f"launches_{form}")) == (before[0] + 1,
                                                  before[1] + 1)
    assert got.dtype == dt and got.shape == (B, L - window + 1, C)
    want = tsp.sliding_pool_plain(x, window=window, op=op,
                                  method=method or "scan")
    if op == "max":
        assert torch.equal(got, want)
        other = "shift" if method == "scan" else "scan"
        assert torch.equal(got, tsp.sliding_pool(x, window=window, op="max",
                                                 method=other))
    else:  # the plain version's layout and float32 order: bit for bit
        assert torch.equal(got, want)
        _close(got, want)


def _pool_forms_match_plain(x, window):
    """Every form of row 8 and the sum gradient on one input, each one
    launch: sum, avg and the gradient bit for bit equal to the plain
    version (the same layout, the same float32 order) and as ``_close``;
    max exact, scan equal to shift."""
    ys = {}
    for form in ("sum", "avg", "max_scan", "max_shift"):
        op, _, method = form.partition("_")
        before = getattr(tsp.sliding_pool, f"launches_{form}")
        got = tsp.sliding_pool(x, window=window, op=op,
                               method=method or "scan")
        assert getattr(tsp.sliding_pool, f"launches_{form}") == before + 1
        want = tsp.sliding_pool_plain(x, window=window, op=op,
                                      method=method or "scan")
        assert torch.equal(got, want), form
        _close(got, want)
        ys[form] = got
    assert torch.equal(ys["max_scan"], ys["max_shift"])
    dy = _randn(window + 1, ys["sum"].shape, x.device, x.dtype)
    before = tsp.sum_pool_bwd.launches
    got = tsp.sum_pool_bwd(dy, window=window)
    assert tsp.sum_pool_bwd.launches == before + 1
    want = tsp.sum_pool_bwd_plain(dy, window=window)
    assert torch.equal(got, want)
    _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "zeros", "relu"])
def test_pool_forms_at_the_wide_bf16_window(card, kind):
    """(8, 2000, 1024) at w = 200 in bf16, where a parallel scan's float32
    order once moved the average two bf16 steps: every form and the sum
    gradient on normals, zeros and post-relu normals."""
    shape = (8, 2000, 1024)
    x = (torch.zeros(shape, device=card, dtype=torch.bfloat16)
         if kind == "zeros" else
         _randn(200, shape, card, torch.bfloat16, relu=kind == "relu"))
    _pool_forms_match_plain(x, 200)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,C,window", [(2, 3000, 37, 2000),
                                          (3, 70011, 1, 60000),
                                          (1, 2500, 32, 2500)])
def test_pool_forms_on_a_streamed_halo(card, B, L, C, window, dtype):
    """Windows whose halo does not fit a block's shared memory: the block
    streams it in pieces (``pool_layout`` says so for every form), at C =
    37 and C = 1 with ragged last blocks, and w = L."""
    dt = getattr(torch, dtype)
    el = dt.itemsize
    for form in tsp.FORMS:
        lay = tsp.pool_layout(B, L - window + 1, C, window, form, el,
                              build.sm_count(torch.device(card)))
        assert lay.streamed(window), form
    _pool_forms_match_plain(_randn(L + C, (B, L, C), card, dt), window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [1, 3, 64])
def test_sum_pool_bwd_kernel_matches_plain(card, window, dtype):
    dt = getattr(torch, dtype)
    dy = _randn(window, (2, 300 - window + 1, 37), card, dt)
    before = tsp.sum_pool_bwd.launches
    got = tsp.sum_pool_bwd(dy, window=window)
    assert tsp.sum_pool_bwd.launches == before + 1
    assert got.shape == (2, 300, 37) and got.dtype == dt
    _close(got, tsp.sum_pool_bwd_plain(dy, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("window", [1, 3, 9, 100])
def test_max_pool_bwd_kernel_matches_plain(card, window, relu, dtype):
    """Row 9: one launch; as ``_close`` to the plain version (the same
    float32 sums in another order); at ties (post-relu) mass is conserved
    per channel."""
    dt = getattr(torch, dtype)
    x = _randn(window, (2, 300, 37), card, dt, relu=relu)
    y = tsp.sliding_pool(x, window=window, op="max")
    dy = torch.ones_like(y) if relu else _randn(7, y.shape, card, dt)
    before = tsp.max_pool_bwd.launches
    got = tsp.max_pool_bwd(x, y, dy, window=window)
    assert tsp.max_pool_bwd.launches == before + 1
    assert got.shape == x.shape and got.dtype == dt
    _close(got, tsp.max_pool_bwd_plain(x, y, dy, window=window))
    if relu and dtype == "float32":
        torch.testing.assert_close(got.sum(dim=(0, 1)),
                                   torch.full((37,), 2.0 * y.shape[1],
                                              device=card),
                                   rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["normal", "ints", "zeros"])
@pytest.mark.parametrize("B,L,C,window", [(4, 4096, 64, 3), (2, 3000, 300, 5),
                                          (8, 3000, 1024, 300),
                                          (1, 1000, 3, 266), (2, 300, 5, 300),
                                          (1, 1000, 3, 37), (3, 77, 1, 40)])
def test_max_pool_bwd_kernel_tiles_and_slots(card, B, L, C, window, kind,
                                             dtype):
    """Row 9 where one lane walks several blocks (the first two shapes),
    with its slots in global scratch (w 300 at one lane a block), and where
    lanes share each block (the rest: w > L / 2, w = L, C = 1, a share
    that does not divide w); ties from a small integer set."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(L + C + window)
    if kind == "ints":
        x = torch.from_numpy(rng.integers(-2, 3, size=(B, L, C)).astype(
            np.float32)).to(card, dt)
    elif kind == "zeros":
        x = torch.zeros((B, L, C), device=card, dtype=dt)
    else:
        x = _randn(window, (B, L, C), card, dt)
    y = tsp.sliding_pool(x, window=window, op="max")
    dy = _randn(8, y.shape, card, dt)
    before = tsp.max_pool_bwd.launches
    got = tsp.max_pool_bwd(x, y, dy, window=window)
    assert tsp.max_pool_bwd.launches == before + 1
    _close(got, tsp.max_pool_bwd_plain(x, y, dy, window=window))
    assert torch.equal(got, tsp.max_pool_bwd(x, y, dy, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,D,N", [(2, 37, 24, 8), (1, 1, 5, 4),
                                     (2, 130, 200, 16), (1, 64, 129, 3),
                                     (2, 37, 24, 17), (1, 70, 130, 20),
                                     (2, 37, 24, 65), (1, 70, 130, 128)])
def test_ssm_scan_kernel_matches_plain(card, B, L, D, N, dtype):
    """Row 16: one launch; y and h_last within 1e-5 of max (f32), y within
    one bf16 step (bf16); any L and D, no padding; any N (17 and 20 at the
    next compiled width, masked; 65 and 128 in groups of 64)."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(L + D + N)
    abar = torch.from_numpy(rng.uniform(0.3, 1.0, size=(B, L, D, N)).astype(
        np.float32)).to(card, dt)
    bx = _randn(1, (B, L, D, N), card, dt)
    c = _randn(2, (B, L, N), card, dt)
    h0 = _randn(3, (B, D, N), card, torch.float32)
    before = tss.ssm_scan.launches
    y, h = tss.ssm_scan(abar, bx, c, h0)
    assert tss.ssm_scan.launches == before + 1
    assert y.dtype == dt and h.dtype == torch.float32
    yw, hw = tss.ssm_scan_plain(abar, bx, c, h0)
    _close(y, yw)
    _close(h, hw)


@pytest.mark.cuda
def test_kernels_refuse_other_types(card):
    x = torch.zeros(1, 10, 2, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        tsp.sliding_pool(x, window=3)
    with pytest.raises(TypeError):
        tsp.sum_pool_bwd(x, window=3)
    with pytest.raises(TypeError):
        tsp.max_pool_bwd(x, x[:, :8], x[:, :8], window=3)
    a = torch.zeros(1, 4, 3, 2, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        tss.ssm_scan(a, a, torch.zeros(1, 4, 2, device=card,
                                       dtype=torch.float16),
                     torch.zeros(1, 3, 2, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("op,method", [("sum", None), ("avg", None),
                                       ("max", "scan"), ("max", "shift")])
def test_pool1d_grad_on_the_card_matches_cpu(card, op, method):
    """ops.pool1d forward and backward through Pool1d: 1 row-8 launch
    forward; backward 1 sum-bwd launch (sum, avg) or 1 row-9 launch."""
    x = _randn(0, (2, 300, 37), "cpu", torch.float32)
    dy = _randn(1, (2, 292, 37), "cpu", torch.float32)
    outs = []
    for dev in ("cpu", card):
        xd = x.to(dev).detach().requires_grad_()
        before = (tsp.sliding_pool.launches, tsp.sum_pool_bwd.launches,
                  tsp.max_pool_bwd.launches)
        y = tops.pool1d(xd, window=9, op=op, method=method)
        y.backward(dy.to(dev))
        counts = (tsp.sliding_pool.launches - before[0],
                  tsp.sum_pool_bwd.launches - before[1],
                  tsp.max_pool_bwd.launches - before[2])
        if dev == card:
            assert counts == ((1, 0, 1) if op == "max" else (1, 1, 0))
        else:
            assert counts == (0, 0, 0)
        outs.append((y.detach().cpu(), xd.grad.cpu()))
    (yc, gc), (yd, gd) = outs
    _close(yd, yc)
    _close(gd, gc)


@pytest.mark.cuda
def test_conv1d_sliding_backend_runs_the_kernel(card):
    """ops.conv1d(backend="sliding") on a CUDA tensor: one row-1 launch,
    as the reference's "sliding" is its kernel."""
    x = _randn(0, (2, 50, 8), card, torch.float32)
    w = _randn(1, (3, 8, 16), card, torch.float32) / 5
    before = tsc.conv1d_sliding.launches
    got = tops.conv1d(x, w, backend="sliding", padding="SAME",
                      activation="gelu")
    assert tsc.conv1d_sliding.launches == before + 1
    want = tops.conv1d(x.cpu(), w.cpu(), backend="sliding", padding="SAME",
                       activation="gelu")
    _close(got.cpu(), want)
