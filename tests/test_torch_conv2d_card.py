"""The 2-D sliding conv CUDA kernels against their plain versions, on the
card: the fp conv (with its saved pre-activation), the int8 conv and the
weight-gradient kernel, all on ``csrc/gemm_mma.cuh``'s loop: at each copy
width of x, with the plan's split of the reduction and a forced one, at
every activation, output type and int8 mode, at the edge shapes of
``chip_smoke.py``'s phases 24 and 28; two calls bitwise equal.

Needs an NVIDIA card and ``nvcc``; skips without a card. It imports neither
jax nor the JAX package, so it runs where the port runs (``--noconftest``:
the suite's conftest imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_conv2d_card.py -m cuda
"""
import dataclasses

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


# ---------------------------------------------------------------------------
# rows 4 and 14 on gemm_mma.cuh's loop: copy widths, splits, epilogues
# ---------------------------------------------------------------------------

ACTS = ("none", "relu", "gelu", "silu")


@pytest.fixture
def forced_splits(monkeypatch):
    """force(n): every plan the wrappers make from here on splits its
    reduction n ways (as far as its chunks allow)."""
    real = gemm_plan.gemm_plan

    def force(n):
        def plan(M, N, K, dtype, sms=build.DEFAULT_SMS):
            p = real(M, N, K, dtype, sms)
            per = -(-p.chunks // n)
            return dataclasses.replace(p, splits=-(-p.chunks // per), per=per)

        monkeypatch.setattr(gemm_plan, "gemm_plan", plan)
    return force


def _plan(x, w, stride):
    """The plan and x's copy width the wrappers take for this call."""
    B, H, W, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    oh, ow = (H - k) // stride[0] + 1, (W - k) // stride[1] + 1
    plan = gemm_plan.gemm_plan(B * oh * ow, cout, k * k * cin, x.dtype,
                               build.sm_count(x.device))
    va = gemm_plan.copy_bytes(x.element_size(), [x.data_ptr()],
                              gemm_plan.conv2d_copy_strides(H, W, cin, k,
                                                            stride))
    return plan, va


def _bf16_step_close(got, want):
    """bfloat16 within one bf16 step of the float32 value, plus 1e-5 of
    max |want| (float32 sums in another order)."""
    g, w = got.float(), want.float()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30))) - 7)
    assert ((g - w).abs() <= step + 1e-5 * w.abs().max()).all()


def _row4_case(card, dtype, seed, B, H, W, cin, cout, k, stride, act):
    """Row 4 with z against its plain version (float32 within TOL of max
    |y|; bfloat16 y and z within a bf16 step of the plain float32 values),
    one launch a call, two calls bitwise equal. Returns (plan, va)."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    xt = torch.from_numpy(rng.normal(size=(B, H, W, cin)).astype(
        np.float32)).to(card, dt)
    wt = torch.from_numpy((rng.normal(size=(k, k, cin, cout))
                           / np.sqrt(k * k * cin)).astype(np.float32)).to(
        card, dt)
    b = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32)).to(card)
    before = ts2.conv2d_sliding.launches
    y, z = ts2.conv2d_sliding(xt, wt, b, stride=stride, activation=act,
                              save_preact=True)
    assert ts2.conv2d_sliding.launches == before + 1
    y2, z2 = ts2.conv2d_sliding(xt, wt, b, stride=stride, activation=act,
                                save_preact=True)
    assert torch.equal(y, y2) and torch.equal(z, z2)
    if dtype == "float32":
        py, pz = ts2.conv2d_sliding_plain(xt, wt, b, stride=stride,
                                          activation=act, save_preact=True)
        for got, want in ((y, py), (z, pz)):
            scale = max(1.0, want.abs().max().item())
            torch.testing.assert_close(got, want, rtol=TOL["rtol"],
                                       atol=TOL["atol"] * scale)
    else:  # the plain version on the same bf16 operands, not rounded
        py, pz = ts2.conv2d_sliding_plain(xt.float(), wt.float(), b,
                                          stride=stride, activation=act,
                                          save_preact=True)
        _bf16_step_close(y, py)
        _bf16_step_close(z, pz)
    return _plan(xt, wt, stride)


# (dtype, B, H, W, Cin, Cout, k, stride, va): x's copy width from its runs
ROW4_WIDTHS = [
    ("float32", 2, 40, 45, 32, 70, 3, (1, 1), 16),
    ("float32", 2, 40, 44, 6, 70, 3, (2, 2), 8),
    ("float32", 2, 41, 47, 37, 70, 5, (2, 1), 4),
    ("float32", 2, 56, 56, 3, 1152, 14, (14, 14), 8),
    ("bfloat16", 2, 40, 45, 32, 70, 3, (1, 1), 16),
    ("bfloat16", 2, 40, 44, 4, 70, 3, (2, 2), 8),
    ("bfloat16", 2, 56, 56, 3, 1152, 14, (14, 14), 4),
    ("bfloat16", 2, 41, 47, 37, 70, 3, (2, 1), 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 3])
@pytest.mark.parametrize("dtype,B,H,W,cin,cout,k,stride,va", ROW4_WIDTHS)
def test_kernel_copy_widths_and_splits(card, forced_splits, splits, dtype, B,
                                       H, W, cin, cout, k, stride, va):
    """Row 4 at each copy width of x (16, 8, 4 and, in bf16, 2 bytes),
    with the plan's split and forced to 3 (the epilogue then runs after
    the partials are added), every activation across the cases, z saved."""
    if splits:
        forced_splits(splits)
    i = ROW4_WIDTHS.index((dtype, B, H, W, cin, cout, k, stride, va))
    plan, got_va = _row4_case(card, dtype, 500 + i, B, H, W, cin, cout, k,
                              stride, ACTS[i % 4])
    assert got_va == va
    assert plan.splits > 1 or not splits


# the edge shapes of chip_smoke's phase 24 (row 4: x (3, 61, 77, 37), Cout
# 70) and phase 28 (row 14: x (3, 41, 47, Cin), Cout 70): (k, stride,
# activation, Cin)
EDGES_24 = [(3, (2, 2), "none", 37), (5, (2, 1), "relu", 37),
            (7, (1, 3), "gelu", 37), (1, (1, 1), "silu", 37),
            (20, (3, 2), "silu", 37)]
EDGES_28 = [(1, (1, 1), "none", 37), (3, (2, 2), "relu", 130),
            (5, (2, 1), "gelu", 37), (7, (1, 3), "silu", 130),
            (20, (3, 2), "silu", 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride,act,cin", EDGES_24)
def test_kernel_at_phase_24_edges(card, forced_splits, k, stride, act, cin,
                                  dtype, splits):
    if splits:
        forced_splits(splits)
    _row4_case(card, dtype, 520 + k, 3, 61, 77, cin, 70, k, stride, act)


def _row14_inputs(rng, card, mode, x_dtype, B, H, W, cin, cout, k):
    wq = torch.from_numpy(rng.integers(-127, 128, size=(k, k, cin, cout),
                                       dtype=np.int8)).to(card)
    ws = torch.from_numpy((rng.uniform(0.5, 1.5, size=cout)
                           / (73 * np.sqrt(k * k * cin))).astype(np.float32)
                          ).to(card)
    b = torch.from_numpy(rng.normal(size=cout).astype(np.float32)).to(card)
    shape = (B, H, W, cin)
    if mode == "w8a8":
        x = torch.from_numpy(rng.integers(-127, 128, size=shape,
                                          dtype=np.int8)).to(card)
        return x, wq, ws, b, torch.tensor(1 / 73, device=card)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        card, getattr(torch, x_dtype))
    return x, wq, ws, b, None


def _row14_case(card, mode, x_dtype, seed, B, H, W, cin, cout, k, stride,
                act):
    """Row 14 against its plain version for each output: float32 within
    1e-5 of max |y| (w8a8: exact sums, the activation's last bits; w8a16:
    float32 sums in another order), bfloat16 within a bf16 step of the
    plain float32 value, requantized codes equal in w8a8 with no
    activation, else one apart at most and only at ties; one launch a
    call, two calls bitwise equal. Returns (plan, va)."""
    rng = np.random.default_rng(seed)
    x, wq, ws, b, xs = _row14_inputs(rng, card, mode, x_dtype, B, H, W, cin,
                                     cout, k)
    args = dict(x_scale=xs, mode=mode, stride=stride, activation=act)
    y32 = tsq.conv2d_quant_plain(x, wq, ws, b, **args)
    os = (y32.abs().max() * 0.8 / 127).reshape(())
    for out in ("f32", "bf16", "int8"):
        kw = (dict(out_scale=os) if out == "int8" else
              dict(out_dtype=torch.bfloat16 if out == "bf16"
                   else torch.float32))
        before = tsq.conv2d_quant.launches
        got = tsq.conv2d_quant(x, wq, ws, b, **args, **kw)
        assert tsq.conv2d_quant.launches == before + 1
        assert torch.equal(got, tsq.conv2d_quant(x, wq, ws, b, **args, **kw))
        if out == "f32":
            torch.testing.assert_close(got, y32, rtol=0, atol=1e-5 * max(
                1.0, y32.abs().max().item()))
        elif out == "bf16":
            assert got.dtype == torch.bfloat16
            _bf16_step_close(got, y32)
        else:
            want = tsq.conv2d_quant_plain(x, wq, ws, b, out_scale=os, **args)
            if mode == "w8a8" and act == "none":
                assert torch.equal(got, want)
            else:
                diff = (got.int() - want.int()).abs()
                assert diff.max().item() <= 1
                pre = (y32 / os)[diff > 0]
                assert ((pre - pre.round()).abs() - 0.5).abs().max().item() \
                    < 1e-3 if pre.numel() else True
    return _plan(x, wq, stride)


# (mode, x dtype, B, H, W, Cin, Cout, k, stride, va)
ROW14_WIDTHS = [
    ("w8a8", "int8", 2, 40, 45, 32, 70, 3, (1, 1), 16),
    ("w8a8", "int8", 2, 40, 44, 8, 70, 5, (2, 2), 8),
    ("w8a8", "int8", 2, 40, 44, 4, 70, 5, (2, 2), 4),
    ("w8a8", "int8", 2, 56, 56, 3, 1152, 14, (14, 14), 2),
    ("w8a8", "int8", 2, 41, 47, 37, 70, 3, (2, 1), 1),
    ("w8a16", "bfloat16", 2, 56, 56, 3, 1152, 14, (14, 14), 4),
    ("w8a16", "bfloat16", 2, 41, 47, 37, 70, 3, (2, 1), 2),
    ("w8a16", "float32", 2, 40, 45, 32, 70, 3, (1, 1), 16),
    ("w8a16", "float32", 2, 41, 47, 37, 70, 5, (2, 1), 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 3])
@pytest.mark.parametrize("mode,x_dtype,B,H,W,cin,cout,k,stride,va",
                         ROW14_WIDTHS)
def test_int8_kernel_copy_widths_and_splits(card, forced_splits, splits, mode,
                                            x_dtype, B, H, W, cin, cout, k,
                                            stride, va):
    """Row 14 at each copy width of x (int8: 16, 8, 4, 2, 1 bytes; w8a16
    on bf16 and float32 x), with the plan's split and forced to 3 (int32
    partials for w8a8), float32, bf16 and requantized outputs, every
    activation across the cases."""
    if splits:
        forced_splits(splits)
    i = ROW14_WIDTHS.index((mode, x_dtype, B, H, W, cin, cout, k, stride,
                            va))
    plan, got_va = _row14_case(card, mode, x_dtype, 540 + i, B, H, W, cin,
                               cout, k, stride, ACTS[i % 4])
    assert got_va == va
    assert plan.splits > 1 or not splits


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 4])
@pytest.mark.parametrize("mode,x_dtype", [("w8a8", "int8"),
                                          ("w8a16", "float32"),
                                          ("w8a16", "bfloat16")])
@pytest.mark.parametrize("k,stride,act,cin", EDGES_28)
def test_int8_kernel_at_phase_28_edges(card, forced_splits, k, stride, act,
                                       cin, mode, x_dtype, splits):
    if splits:
        forced_splits(splits)
    _row14_case(card, mode, x_dtype, 560 + k, 3, 41, 47, cin, 70, k, stride,
                act)
