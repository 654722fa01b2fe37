"""The 2-D sliding conv CUDA kernels against their plain versions, on the
card: the fp conv (with its saved pre-activation), the int8 conv and the
weight-gradient kernel.

Needs an NVIDIA card and ``nvcc``; skips without a card. It imports neither
jax nor the JAX package, so it runs where the port runs (``--noconftest``:
the suite's conftest imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_conv2d_card.py -m cuda
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, gemm_plan  # noqa: E402
from repro_torch.kernels import sliding_conv2d as ts2  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as tbwd  # noqa: E402
from repro_torch.kernels import sliding_conv_quant as tsq  # noqa: E402

TOL = dict(rtol=3e-4, atol=3e-4)  # float32, sums in another order
BTOL = dict(rtol=5e-2, atol=5e-2)  # bfloat16, compared in float32
# (k, stride): every regime, the strides (1,1), (2,2), (1,2) and (14,14)
SHAPES = [(3, (1, 1)), (5, (2, 2)), (7, (1, 2)), (14, (14, 14)),
          (19, (1, 1)), (31, (2, 2))]


def _inputs(seed, H, W, Cin, Cout, k):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, H, W, Cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, Cin, Cout)) / np.sqrt(k * k * Cin)).astype(
        np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    return x, w, b


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride", SHAPES)
def test_kernel_matches_plain_on_the_card(k, stride, dtype):
    """One launch, counted; float32 within TOL, bfloat16 within BTOL; Cin
    37 is a ragged channel chunk and Cout 70 a ragged block."""
    import repro_torch

    repro_torch.resolve_device("cuda")  # full float32: TF32 off
    dt = getattr(torch, dtype)
    x, w, b = _inputs(k + 40, k + 30, k + 33, 37, 70, k)
    xt = torch.from_numpy(x).to("cuda", dt)
    wt = torch.from_numpy(w).to("cuda", dt)
    bt = torch.from_numpy(b).cuda()
    before = ts2.conv2d_sliding.launches
    got = ts2.conv2d_sliding(xt, wt, bt, stride=stride, activation="silu")
    assert ts2.conv2d_sliding.launches == before + 1
    want = ts2.conv2d_sliding_plain(xt, wt, bt, stride=stride,
                                    activation="silu")
    torch.testing.assert_close(got.float(), want.float(),
                               **(TOL if dtype == "float32" else BTOL))


@pytest.fixture
def card():
    """Skip without a card; full float32 (TF32 off) with one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repro_torch

    repro_torch.resolve_device("cuda")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride", SHAPES)
def test_saved_preact_matches_plain_on_the_card(card, k, stride):
    """y as without ``save_preact``, z the plain post-bias sum (TOL)."""
    x, w, b = _inputs(k + 50, k + 30, k + 33, 37, 70, k)
    xt, wt, bt = (torch.from_numpy(a).to(card) for a in (x, w, b))
    y, z = ts2.conv2d_sliding(xt, wt, bt, stride=stride, activation="gelu",
                              save_preact=True)
    assert torch.equal(y, ts2.conv2d_sliding(xt, wt, bt, stride=stride,
                                             activation="gelu"))
    _, pz = ts2.conv2d_sliding_plain(xt, wt, bt, stride=stride,
                                     activation="gelu", save_preact=True)
    torch.testing.assert_close(z, pz, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
@pytest.mark.parametrize("k,stride", SHAPES)
def test_int8_kernel_matches_plain_on_the_card(card, k, stride, mode):
    """One launch, counted. w8a8 sums exactly: float32 outputs within
    1e-5 (the activation's last bits) and requantized codes equal but for
    one-code ties; w8a16 sums in float32 in another order: within 1e-5 of
    max |y|. Cin 37 is not a multiple of 4; Cin 3 at k 14 is the patch
    embedding's odd-byte run."""
    rng = np.random.default_rng(k + 60)
    cin = 3 if k == 14 else 37
    wq = torch.from_numpy(rng.integers(-127, 128, size=(k, k, cin, 70),
                                       dtype=np.int8)).to(card)
    ws = torch.from_numpy((rng.uniform(0.5, 1.5, size=70)
                           / (73 * np.sqrt(k * k * cin))).astype(np.float32)
                          ).to(card)
    b = torch.from_numpy(rng.normal(size=70).astype(np.float32)).to(card)
    shape = (2, k + 30, k + 33, cin)
    if mode == "w8a8":
        x = torch.from_numpy(rng.integers(-127, 128, size=shape,
                                          dtype=np.int8)).to(card)
        xs = torch.tensor(1 / 73, device=card)
    else:
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(card)
        xs = None
    args = dict(x_scale=xs, mode=mode, stride=stride, activation="silu")
    before = tsq.conv2d_quant.launches
    got = tsq.conv2d_quant(x, wq, ws, b, **args)
    assert tsq.conv2d_quant.launches == before + 1
    want = tsq.conv2d_quant_plain(x, wq, ws, b, **args)
    atol = 1e-5 * (1.0 if mode == "w8a8" else want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
    os = (want.abs().max() * 0.8 / 127).reshape(())
    got_q = tsq.conv2d_quant(x, wq, ws, b, out_scale=os, **args)
    want_q = tsq.conv2d_quant_plain(x, wq, ws, b, out_scale=os, **args)
    diff = (got_q.int() - want_q.int()).abs()
    assert diff.max().item() <= 1 and diff.float().mean().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride", SHAPES)
def test_dw_kernel_matches_plain_on_the_card(card, k, stride, dtype):
    """One launch, counted; dw and db in float32 within TOL of max |dw|
    (sums over every output position in another order); two calls bitwise
    equal."""
    cin = 3 if k == 14 else 37
    _dw_case(card, dtype, k + 70, 2, k + 30, k + 33, cin, 70, k, stride)


def _dw_case(card, dtype, seed, B, H, W, cin, cout, k, stride, offset=0):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    oh, ow = (H - k) // stride[0] + 1, (W - k) // stride[1] + 1
    x = torch.from_numpy(rng.normal(size=(B * H * W * cin + offset,)).astype(
        np.float32)).to(card, dt)[offset:].view(B, H, W, cin)
    dz = torch.from_numpy(rng.normal(size=(B, oh, ow, cout)).astype(
        np.float32)).to(card, dt)
    before = tbwd.conv2d_bwd_dw.launches
    dw, db = tbwd.conv2d_bwd_dw(x, dz, (k, k), stride=stride, has_bias=True)
    assert tbwd.conv2d_bwd_dw.launches == before + 1
    again = tbwd.conv2d_bwd_dw(x, dz, (k, k), stride=stride, has_bias=True)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])
    pdw, pdb = tbwd.conv2d_bwd_dw_plain(x, dz, (k, k), stride=stride,
                                        has_bias=True)
    for got, want in ((dw, pdw), (db, pdb)):
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale)
    return gemm_plan.gemm_plan(k * k * cin, cout, B * oh * ow, dt,
                               build.sm_count(x.device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,W,cin,cout,k,stride,offset,splits", [
    # llava's patch runs (42 values: 4-byte copies in bf16), Cout 1152
    (2, 56, 56, 3, 1152, 14, (14, 14), 0, False),
    (8, 112, 112, 3, 1152, 14, (14, 14), 0, True),
    (20, 336, 336, 3, 1152, 14, (14, 14), 0, True),  # the patch itself
    (8, 112, 112, 3, 1152, 14, (14, 14), 1, True),   # x 1 element off
    (1, 50, 50, 32, 32, 21, (1, 1), 0, True),        # fig1-like, Cout 32
    (2, 40, 45, 8, 70, 5, (1, 1), 0, True),          # Cin 8, Cout 70
    (2, 40, 44, 16, 32, 9, (2, 2), 0, True),         # stride 2
    (2, 20, 23, 5, 1, 1, (1, 1), 0, True),           # M = 5 < 16, Cout 1
    (1, 9, 9, 3, 33, 3, (2, 2), 0, False),           # one chunk
    (1, 8, 8, 512, 1024, 3, (1, 1), 0, False),       # tiles fill the card
])
def test_dw_kernel_edges_and_repeatable(card, B, H, W, cin, cout, k, stride,
                                        offset, splits, dtype):
    """Row 12 where nothing is a multiple of a tile, on runs that allow
    16-, 8-, 4- or 2-byte copies, blocks over up to five filter rows, split
    and not (as ``gemm_plan`` says for this card): within TOL, two calls
    bitwise equal."""
    plan = _dw_case(card, dtype, B + cin + cout + k, B, H, W, cin, cout, k,
                    stride, offset)
    assert (plan.splits > 1) == splits
