"""The GEMM-convolution baseline kernels against their plain versions, on
the card: the tiled GEMM (``im2col_gemm.matmul``), the fused 1-D and 2-D
im2col convolutions (each at each copy width of its tap-by-tap gather,
split and not), the column-tensor (hbm) baselines on the GEMM kernel, and
``ops``'s im2col backends.

Needs an NVIDIA card and ``nvcc``; skips without a card. It imports neither
jax nor the JAX package, so it runs where the port runs (``--noconftest``:
the suite's conftest imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_im2col_card.py -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, gemm_plan  # noqa: E402
from repro_torch.kernels import im2col_gemm as tig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402


@pytest.fixture
def card():
    """Skip without a card; full float32 (TF32 off) with one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repro_torch

    repro_torch.resolve_device("cuda")
    return "cuda"


def _close(got, want, dtype):
    """float32: within 1e-5 of max |want| (sums in another order);
    bfloat16: within one bf16 step of the plain float32 value plus 1e-5 of
    max |want|."""
    g, w = got.float(), want.float()
    assert g.shape == w.shape and torch.isfinite(g).all()
    top = w.abs().max().item()
    if dtype == torch.float32:
        tol = 1e-5 * max(1.0, top)
    else:
        tol = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30))) - 7
                         ) + 1e-5 * top
    assert ((g - w).abs() <= tol).all(), (g - w).abs().max().item()


def _randn(rng, shape, scale, dev, dtype):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32)).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(200, 70, 90), (64, 32, 64), (1, 1, 1),
                                   (333, 517, 65), (129, 31, 1152)])
def test_matmul_kernel_matches_plain(card, M, K, N, dtype):
    """One launch, counted; ragged M, N and K."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(M + K + N)
    a = _randn(rng, (M, K), 1.0, card, dt)
    b = _randn(rng, (K, N), K ** -0.5, card, dt)
    before = tig.matmul.launches
    got = tig.matmul(a, b)
    assert tig.matmul.launches == before + 1 and got.dtype == dt
    want = a.float() @ b.float()
    _close(got, want if dt == torch.bfloat16 else tig.matmul_plain(a, b), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,offset,splits", [
    (11520, 588, 1152, 0, False),  # llava's patch column: bf16 rows 8-byte
    (1000, 588, 1152, 2, True),    # 4-byte aligned A (bf16), split
    (300, 588, 1, 1, True),        # N = 1; A 2 bytes past alignment
    (15, 588, 32, 0, True),        # M < 16, N = 32: the narrow f32 tile
    (9604, 4096, 32, 0, True),     # a long column, N = 32, split
    (777, 31, 33, 0, False),       # K, N under a chunk and ragged
    (40000, 64, 128, 0, False),    # the blocks alone fill the card
])
def test_matmul_kernel_edges_and_repeatable(card, M, K, N, offset, splits,
                                            dtype):
    """Row 5 where nothing is a multiple of a tile, on operands whose rows
    allow 16-, 8-, 4- or 2-byte copies (A ``offset`` elements into its
    storage), split and not (as ``gemm_plan`` says for this card): one
    launch, counted, within the tolerance of the test above, and two
    calls bitwise equal."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(M + K + N + offset)
    flat = _randn(rng, (M * K + offset,), 1.0, card, dt)
    a = flat[offset:].view(M, K)
    b = _randn(rng, (K, N), K ** -0.5, card, dt)
    plan = gemm_plan.gemm_plan(M, N, K, dt, build.sm_count(a.device))
    assert (plan.splits > 1) == splits
    before = tig.matmul.launches
    got = tig.matmul(a, b)
    assert tig.matmul.launches == before + 1 and got.dtype == dt
    assert torch.equal(got, tig.matmul(a, b))
    want = a.float() @ b.float()
    _close(got, want if dt == torch.bfloat16 else tig.matmul_plain(a, b), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,stride,cin", [(3, 1, 37), (7, 2, 3), (17, 3, 37),
                                          (1, 1, 5)])
def test_conv1d_kernel_matches_plain(card, K, stride, cin, dtype):
    """Row 6 and the hbm baseline (row 5 once), each one launch."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(K * 10 + stride)
    x = _randn(rng, (3, 301, cin), 1.0, card, dt)
    w = _randn(rng, (K, cin, 70), (K * cin) ** -0.5, card, dt)
    want = tig.conv1d_im2col_fused_plain(x.float(), w.float(), stride=stride)
    before = (tig.conv1d_im2col_fused.launches, tig.matmul.launches)
    got = tig.conv1d_im2col_fused(x, w, stride=stride)
    hbm = tig.conv1d_im2col_hbm(x, w, stride=stride)
    assert (tig.conv1d_im2col_fused.launches, tig.matmul.launches) == (
        before[0] + 1, before[1] + 1)
    _close(got, want, dt)
    _close(hbm, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kh,kw,stride,cin", [
    (3, 3, (1, 1), 37), (5, 5, (2, 2), 3), (7, 5, (2, 3), 37),
    (14, 14, (14, 14), 3)])
def test_conv2d_kernel_matches_plain(card, kh, kw, stride, cin, dtype):
    """Row 7 and the hbm baseline (row 5 once), each one launch."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(kh * 10 + kw)
    x = _randn(rng, (2, kh + 40, kw + 45, cin), 1.0, card, dt)
    w = _randn(rng, (kh, kw, cin, 70), (kh * kw * cin) ** -0.5, card, dt)
    want = tig.conv2d_im2col_fused_plain(x.float(), w.float(), stride=stride)
    before = (tig.conv2d_im2col_fused.launches, tig.matmul.launches)
    got = tig.conv2d_im2col_fused(x, w, stride=stride)
    hbm = tig.conv2d_im2col_hbm(x, w, stride=stride)
    assert (tig.conv2d_im2col_fused.launches, tig.matmul.launches) == (
        before[0] + 1, before[1] + 1)
    _close(got, want, dt)
    _close(hbm, want, dt)


@pytest.fixture
def forced_splits(monkeypatch):
    """force(n, tile=None): every plan the wrappers make from here on
    splits its reduction n ways (as far as its chunks allow; None leaves
    the split to the rule) on ``tile`` (a ``gemm_plan.TILES`` name; None
    leaves the tile to the rule)."""
    real = gemm_plan.gemm_plan

    def force(n, tile=None):
        def plan(M, N, K, dtype, sms=build.DEFAULT_SMS, **rule):
            return real(M, N, K, dtype, sms, tile=tile or rule.get("tile"),
                        splits=n or rule.get("splits"))

        monkeypatch.setattr(gemm_plan, "gemm_plan", plan)
    return force


# (dtype, B, H, W, Cin, Cout, k, stride, va): row 7's copy width of x, one
# tap's Cin channels at most
ROW7_WIDTHS = [
    ("float32", 2, 40, 45, 32, 70, 3, (1, 1), 16),
    ("float32", 2, 40, 44, 6, 70, 3, (2, 2), 8),
    ("float32", 2, 41, 47, 37, 70, 5, (2, 1), 4),
    ("float32", 2, 56, 56, 3, 1152, 14, (14, 14), 4),
    ("bfloat16", 2, 40, 45, 32, 70, 3, (1, 1), 16),
    ("bfloat16", 2, 40, 44, 4, 70, 3, (2, 2), 8),
    ("bfloat16", 2, 40, 44, 6, 33, 5, (2, 3), 4),
    ("bfloat16", 2, 56, 56, 3, 1152, 14, (14, 14), 2),
    ("bfloat16", 2, 41, 47, 37, 70, 3, (2, 1), 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 3])
@pytest.mark.parametrize("dtype,B,H,W,cin,cout,k,stride,va", ROW7_WIDTHS)
def test_conv2d_kernel_copy_widths_and_splits(card, forced_splits, splits,
                                              dtype, B, H, W, cin, cout, k,
                                              stride, va):
    """Row 7 on gemm_mma.cuh's loop at each copy width of x (16, 8, 4 and,
    in bf16, 2 bytes), with the plan's split and forced to 3 (the
    partials added in split order): one launch, as the test above to the
    plain version, two calls bitwise equal."""
    if splits:
        forced_splits(splits)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(ROW7_WIDTHS.index(
        (dtype, B, H, W, cin, cout, k, stride, va)))
    x = _randn(rng, (B, H, W, cin), 1.0, card, dt)
    w = _randn(rng, (k, k, cin, cout), (k * k * cin) ** -0.5, card, dt)
    oh, ow = (H - k) // stride[0] + 1, (W - k) // stride[1] + 1
    plan, got_va, _, _ = tig.conv2d_launch(x, w, stride, oh, ow)
    assert got_va == va and (plan.splits > 1 or not splits)
    before = tig.conv2d_im2col_fused.launches
    got = tig.conv2d_im2col_fused(x, w, stride=stride)
    assert tig.conv2d_im2col_fused.launches == before + 1
    assert torch.equal(got, tig.conv2d_im2col_fused(x, w, stride=stride))
    _close(got, tig.conv2d_im2col_fused_plain(x.float(), w.float(),
                                              stride=stride), dt)


# (dtype, B, L, Cin, Cout, K, stride, va): row 6's copy width of x, one
# tap's Cin channels at most; the 1-D table's Cout 32 (the narrow f32
# tile) and whisper's conv2 cut in length among them
ROW6_WIDTHS = [
    ("float32", 2, 300, 32, 32, 17, 1, 16),
    ("float32", 2, 300, 6, 70, 5, 2, 8),
    ("float32", 3, 301, 37, 70, 7, 3, 4),
    ("float32", 2, 301, 3, 33, 65, 1, 4),
    ("float32", 2, 130, 1024, 1024, 3, 2, 16),
    ("bfloat16", 2, 300, 32, 32, 17, 1, 16),
    ("bfloat16", 2, 300, 4, 70, 9, 2, 8),
    ("bfloat16", 2, 300, 6, 33, 7, 3, 4),
    ("bfloat16", 2, 301, 3, 70, 65, 1, 2),
    ("bfloat16", 3, 301, 37, 70, 3, 2, 2),
    ("bfloat16", 2, 130, 1024, 1024, 3, 2, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 3])
@pytest.mark.parametrize("dtype,B,L,cin,cout,K,stride,va", ROW6_WIDTHS)
def test_conv1d_kernel_copy_widths_and_splits(card, forced_splits, splits,
                                              dtype, B, L, cin, cout, K,
                                              stride, va):
    """Row 6 on gemm_mma.cuh's loop at each copy width of x (16, 8, 4 and,
    in bf16, 2 bytes), with the plan's split and forced to 3: one launch,
    as the 1-D test above to the plain version, two calls bitwise
    equal."""
    if splits:
        forced_splits(splits)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(ROW6_WIDTHS.index(
        (dtype, B, L, cin, cout, K, stride, va)))
    x = _randn(rng, (B, L, cin), 1.0, card, dt)
    w = _randn(rng, (K, cin, cout), (K * cin) ** -0.5, card, dt)
    lout = (L - K) // stride + 1
    plan, got_va, _, _ = tig.conv1d_launch(x, w, stride, lout)
    assert got_va == va and (plan.splits > 1 or not splits)
    before = tig.conv1d_im2col_fused.launches
    got = tig.conv1d_im2col_fused(x, w, stride=stride)
    assert tig.conv1d_im2col_fused.launches == before + 1
    assert torch.equal(got, tig.conv1d_im2col_fused(x, w, stride=stride))
    _close(got, tig.conv1d_im2col_fused_plain(x.float(), w.float(),
                                              stride=stride), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,va", [("float32", 4), ("bfloat16", 2)])
def test_conv1d_kernel_unaligned_base(card, dtype, va):
    """Row 6 on x one element past its storage's 16-byte alignment: the
    copies narrow to the pointer, the result does not move."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    x = _randn(rng, (2 * 300 * 32 + 1,), 1.0, card, dt)[1:].view(2, 300, 32)
    w = _randn(rng, (17, 32, 32), (17 * 32) ** -0.5, card, dt)
    assert tig.conv1d_launch(x, w, 1, 284)[1] == va
    got = tig.conv1d_im2col_fused(x, w)
    _close(got, tig.conv1d_im2col_fused_plain(x.float(), w.float()), dt)


@pytest.mark.cuda
def test_ops_backends_launch_the_kernels_and_refuse_grads(card):
    """``ops.conv2d(im2col_gemm)`` runs row 7 once (not the column twin),
    ``im2col_hbm`` row 5 once; a call that needs a gradient raises."""
    rng = np.random.default_rng(5)
    x = _randn(rng, (2, 20, 23, 4), 1.0, card, torch.float32)
    w = _randn(rng, (3, 3, 4, 6), 1 / 6, card, torch.float32)
    b = _randn(rng, (6,), 1.0, card, torch.float32)
    want = tops.conv2d(x, w, bias=b, activation="gelu", padding="SAME",
                       backend="xla")
    for backend, counter in (("im2col_gemm", tig.conv2d_im2col_fused),
                             ("im2col_hbm", tig.matmul)):
        before = counter.launches
        got = tops.conv2d(x, w, bias=b, activation="gelu", padding="SAME",
                          backend=backend)
        assert counter.launches == before + 1, backend
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
        with pytest.raises(NotImplementedError, match="forward only"):
            tops.conv2d(x, w.clone().requires_grad_(), backend=backend)
    with pytest.raises(NotImplementedError, match="forward only"):
        tops.matmul(x[0, 0], w[0, 0].clone().requires_grad_())
