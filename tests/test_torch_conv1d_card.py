"""The 1-D kernels on ``csrc/gemm_mma.cuh``'s loop against their plain
versions, on the card.

Row 1, the sliding conv (``csrc/sliding_conv1d.cu``): filters of 1 to 2049
taps (a halo no block's shared memory holds), strides 1-3, Cin 3, 37, 80
and 1024 (copies of x 4 to 16 bytes wide, and 2-byte plain loads in bf16),
every activation with and without bias, y and the saved pre-activation z,
the plan's split of the reduction and forced splits of 1 and 3, x one
element off its storage's alignment, whisper's frontend at full width; one
launch a call, two calls bitwise equal.

Row 13, the int8 conv (``csrc/sliding_conv_quant.cu``): w8a8 and w8a16
(float32, bfloat16 x), float and requantized int8 outputs, at whisper's
int8 frontend and ``chip_smoke.py`` phase 11's edges (Cin 37 and 80 with
no channel padding, K 1-20, strides 1-2), the plan's split and forced
splits of 1 and 3, x one code or element off its alignment. Row 10, the
weight gradient (``csrc/sliding_conv_bwd.cu``): float32 and bfloat16 at
whisper's frontend and phase 7's edges, with and without db, the same
splits and offsets.

Needs an NVIDIA card and ``nvcc``; skips without a card. It imports neither
jax nor the JAX package, so it runs where the port runs (``--noconftest``:
the suite's conftest imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_conv1d_card.py -m cuda
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, gemm_plan  # noqa: E402
from repro_torch.kernels import sliding_conv1d as tsc  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as tsb  # noqa: E402
from repro_torch.kernels import sliding_conv_quant as tsq  # noqa: E402

TOL = dict(rtol=3e-4, atol=3e-4)  # float32, sums in another order
BTOL = dict(rtol=5e-2, atol=5e-2)  # bfloat16, compared in float32
ACTS = ("none", "relu", "gelu", "silu")
# (B, L, Cin, Cout, K, stride): K 1 to 2049, strides 1-3, Cin 3, 37, 80
# and 1024, Cout 1, 33, 70 and 1024 (ragged tiles, the narrow f32 tile)
SHAPES = [(3, 203, 3, 70, 1, 1), (2, 130, 80, 1024, 3, 1),
          (2, 130, 1024, 1024, 3, 2), (3, 203, 37, 70, 7, 3),
          (2, 300, 37, 33, 65, 1), (1, 1000, 80, 32, 65, 2),
          (2, 2300, 3, 70, 2049, 1), (1, 2300, 37, 70, 2049, 3),
          (2, 50, 37, 1, 3, 2)]


@pytest.fixture
def card():
    """Skip without a card; full float32 (TF32 off) with one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repro_torch

    repro_torch.resolve_device("cuda")
    return "cuda"


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


def _inputs(card, seed, B, L, Cin, Cout, K, dtype, with_bias, offset=0):
    """x (``offset`` elements into its storage), w and bias from a seed."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.normal(size=(B * L * Cin + offset,)).astype(
        np.float32)).to(card, dtype)
    x = flat[offset:].view(B, L, Cin)
    w = torch.from_numpy((rng.normal(size=(K, Cin, Cout))
                          / np.sqrt(K * Cin)).astype(np.float32)).to(
        card, dtype)
    b = (torch.from_numpy(rng.normal(size=(Cout,)).astype(np.float32)).to(
        card) if with_bias else None)
    return x, w, b


def _case(x, w, b, stride, act):
    """y and z from one launch (counted) against the plain version (TOL or
    BTOL, z too), y as without ``save_preact``, two calls bitwise equal.
    Returns the plan and x's copy width the wrapper took."""
    tol = TOL if x.dtype == torch.float32 else BTOL
    before = tsc.conv1d_sliding.launches
    y, z = tsc.conv1d_sliding(x, w, b, stride=stride, activation=act,
                              save_preact=True)
    assert tsc.conv1d_sliding.launches == before + 1
    assert y.dtype == z.dtype == x.dtype
    y2 = tsc.conv1d_sliding(x, w, b, stride=stride, activation=act)
    assert torch.equal(y, y2)
    py, pz = tsc.conv1d_sliding_plain(x, w, b, stride=stride, activation=act,
                                      save_preact=True)
    torch.testing.assert_close(y.float(), py.float(), **tol)
    torch.testing.assert_close(z.float(), pz.float(), **tol)
    plan, va, _, _ = tsc.conv1d_launch(x, w, stride, y.shape[1])
    return plan, va


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,Cin,Cout,K,stride", SHAPES)
def test_kernel_matches_plain(card, forced_splits, B, L, Cin, Cout, K,
                              stride, dtype, splits):
    """Each shape with the plan's split and forced to 1 and 3 splits
    (float32 partials added in split order), an activation and a bias by
    the shape's place in the list."""
    if splits:
        forced_splits(splits)
    i = SHAPES.index((B, L, Cin, Cout, K, stride))
    x, w, b = _inputs(card, i, B, L, Cin, Cout, K, getattr(torch, dtype),
                      with_bias=i % 2 == 0)
    plan, _ = _case(x, w, b, stride, ACTS[i % 4])
    if splits:
        assert (plan.splits > 1) == (splits > 1 and plan.chunks > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_activation_with_splits(card, dtype, act, with_bias):
    """Every activation, with and without bias, y and z, at whisper's conv2
    cut in length: 8 tiles, split by the plan (the epilogue runs after
    the partials are added)."""
    x, w, b = _inputs(card, 7, 2, 130, 1024, 1024, 3, getattr(torch, dtype),
                      with_bias)
    plan, va = _case(x, w, b, 2, act)
    assert plan.splits > 1 and va == 16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Cin,va", [
    ("float32", 80, 4), ("bfloat16", 80, 2), ("float32", 37, 4),
    ("bfloat16", 1024, 2)])
def test_unaligned_base(card, dtype, Cin, va):
    """x one element past its storage's 16-byte alignment (a slice): the
    copies narrow to the pointer's alignment, the result does not move."""
    x, w, b = _inputs(card, Cin, 2, 131, Cin, 70, 3, getattr(torch, dtype),
                      True, offset=1)
    _, got_va = _case(x, w, b, 2, "gelu")
    assert got_va == va


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Cin,stride", [(80, 1), (1024, 2)])
def test_whisper_frontend(card, Cin, stride, dtype):
    """whisper-medium's frontend at full width (B=4, 514 padded mel rows,
    -> 1024 channels, bias + gelu), in float32 and in bfloat16, which
    whisper serves in: 16-byte copies of x."""
    x, w, b = _inputs(card, Cin + stride, 4, 514, Cin, 1024, 3,
                      getattr(torch, dtype), True)
    _, va = _case(x, w, b, stride, "gelu")
    assert va == 16


# ---------------------------------------------------------------------------
# row 13: the int8 conv
# ---------------------------------------------------------------------------

# the int8 conv's float32 outputs: w8a8 sums are exact, so only the
# activation's last bits differ; w8a16 sums in float32 in another order,
# held to 1e-5 of the largest output (chip_smoke.py's TIGHT); a bfloat16
# output may round the other way: two bf16 steps (QBTOL)
TIGHT = dict(rtol=1e-5, atol=1e-5)
QBTOL = dict(rtol=1e-2, atol=1e-2)
QMODES = [("w8a8", "int8"), ("w8a16", "float32"), ("w8a16", "bfloat16")]
# (B, L, Cin, Cout, K, stride): whisper's int8 frontend at full width, then
# phase 11's edges (Cin 37 and 80, K 1-20, strides 1-2)
QSHAPES = [(4, 514, 80, 1024, 3, 1), (4, 514, 1024, 1024, 3, 2),
           (3, 203, 37, 70, 1, 1), (3, 203, 37, 70, 7, 2),
           (3, 203, 80, 70, 20, 1), (3, 203, 80, 70, 17, 2),
           (3, 203, 37, 70, 20, 2)]


def _quant_inputs(card, seed, B, L, Cin, Cout, K, mode, x_dtype, offset=0):
    """int8 weight codes with per-Cout scales, a bias, and an int8 input
    with its scale (w8a8) or a float input (w8a16), ``offset`` elements
    into its storage; outputs O(1)."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.integers(-127, 128, size=(K, Cin, Cout),
                                      dtype=np.int8)).to(card)
    ws = torch.from_numpy((rng.uniform(0.5, 1.5, size=Cout)
                           / (73 * np.sqrt(K * Cin))).astype(np.float32)).to(
        card)
    b = torch.from_numpy(rng.normal(size=(Cout,)).astype(np.float32)).to(card)
    n = B * L * Cin + offset
    if mode == "w8a8":
        flat = torch.from_numpy(rng.integers(-127, 128, size=n,
                                             dtype=np.int8)).to(card)
        xs = torch.tensor(1 / 73, device=card)
    else:
        flat = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(
            card, x_dtype)
        xs = None
    return flat[offset:].view(B, L, Cin), w, ws, b, xs


def _codes_close(got, want, pre, tie, max_frac):
    """int8 codes equal but for codes one apart where the plain version's
    ``y / out_scale`` lies within ``tie`` of a half-integer, no more than
    ``max_frac`` of them (chip_smoke.py's codes_close)."""
    assert got.dtype == torch.int8 and got.shape == want.shape
    diff = (got.int() - want.int()).abs()
    off = diff > 0
    near = ((pre - pre.floor()).abs() - 0.5).abs() < tie
    assert diff.max().item() <= 1
    assert not bool((off & ~near).any())
    assert int(off.sum()) <= max_frac * diff.numel()


def _quant_case(x, w, ws, b, xs, mode, stride, act):
    """Row 13's float output (one launch, counted; two calls bitwise equal)
    and its requantized codes on a grid that clips the largest outputs,
    against the plain version. Returns the plan and x's copy width."""
    odt = x.dtype if mode == "w8a16" else torch.float32
    args = dict(x_scale=xs, mode=mode, stride=stride, activation=act)
    before = tsq.conv1d_quant.launches
    got = tsq.conv1d_quant(x, w, ws, b, out_dtype=odt, **args)
    assert tsq.conv1d_quant.launches == before + 1
    assert torch.equal(got, tsq.conv1d_quant(x, w, ws, b, out_dtype=odt,
                                             **args))
    want = tsq.conv1d_quant_plain(x, w, ws, b, out_dtype=odt, **args)
    assert got.dtype == want.dtype == odt
    tol = QBTOL if odt == torch.bfloat16 else TIGHT
    scale = max(1.0, want.float().abs().max().item()) if mode == "w8a16" \
        else 1.0
    torch.testing.assert_close(got.float(), want.float(), rtol=tol["rtol"],
                               atol=tol["atol"] * scale)
    y = tsq.conv1d_quant_plain(x, w, ws, b, out_dtype=torch.float32, **args)
    os = (y.abs().max() * 0.8 / 127).reshape(())
    want_q = tsq.conv1d_quant_plain(x, w, ws, b, out_scale=os, **args)
    got_q = tsq.conv1d_quant(x, w, ws, b, out_scale=os, **args)
    assert want_q.abs().max().item() == 127  # the clip is exercised
    exact = mode == "w8a8"
    _codes_close(got_q, want_q, y / os, tie=1e-4 if exact else 1e-3,
                 max_frac=1e-4 if exact else 1e-3)
    plan, va, _, _ = tsc.conv1d_launch(x.contiguous(), w, stride,
                                       got.shape[1])
    return plan, va


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("mode,x_dtype", QMODES)
@pytest.mark.parametrize("B,L,Cin,Cout,K,stride", QSHAPES)
def test_quant_kernel_matches_plain(card, forced_splits, B, L, Cin, Cout, K,
                                    stride, mode, x_dtype, splits):
    """Each shape and mode with the plan's split and forced to 1 and 3
    splits (int32 partials for w8a8, float32 for w8a16, added in split
    order), float and requantized outputs, an activation by the shape's
    place in the list; Cin 37 and 80 in w8a8 unpadded."""
    if splits:
        forced_splits(splits)
    i = QSHAPES.index((B, L, Cin, Cout, K, stride))
    x, w, ws, b, xs = _quant_inputs(card, 50 + i, B, L, Cin, Cout, K, mode,
                                    getattr(torch, x_dtype))
    plan, va = _quant_case(x, w, ws, b, xs, mode, stride, ACTS[i % 4])
    if splits:
        assert (plan.splits > 1) == (splits > 1 and plan.chunks > 1)
    elif (Cin, Cout) == (1024, 1024):  # whisper's conv2: 64 tiles, split
        assert plan.splits > 1 and va == 16
    if mode == "w8a8" and Cin == 37:
        assert va == 1  # odd runs: single codes, no padding


@pytest.mark.cuda
@pytest.mark.parametrize("mode,x_dtype,va", [
    ("w8a8", "int8", 1), ("w8a16", "float32", 4), ("w8a16", "bfloat16", 2)])
@pytest.mark.parametrize("Cin,stride", [(80, 1), (1024, 2)])
def test_quant_unaligned_base(card, Cin, stride, mode, x_dtype, va):
    """x one code (int8) or one element past its storage's 16-byte
    alignment: the copies narrow to the pointer's alignment, with no
    clone, and the result does not move."""
    x, w, ws, b, xs = _quant_inputs(card, Cin + stride, 2, 131, Cin, 70, 3,
                                    mode, getattr(torch, x_dtype), offset=1)
    _, got_va = _quant_case(x, w, ws, b, xs, mode, stride, "gelu")
    assert got_va == va


# ---------------------------------------------------------------------------
# row 10: the weight gradient
# ---------------------------------------------------------------------------

# (B, L, Cin, Cout, K, stride): whisper's frontend at full width, then
# phase 7's edges (Cin 37, Cout 70, K 1-20, strides 1-3)
DW_SHAPES = [(4, 514, 80, 1024, 3, 1), (4, 514, 1024, 1024, 3, 2),
             (3, 203, 37, 70, 1, 1), (3, 203, 37, 70, 3, 2),
             (3, 203, 37, 70, 5, 3), (3, 203, 37, 70, 7, 1),
             (3, 203, 37, 70, 20, 2)]


def _dw_inputs(card, seed, B, L, Cin, Cout, K, stride, dtype, offset=0):
    rng = np.random.default_rng(seed)
    lout = (L - K) // stride + 1
    flat = torch.from_numpy(rng.normal(size=(B * L * Cin + offset,)).astype(
        np.float32)).to(card, dtype)
    dz = torch.from_numpy(rng.normal(size=(B, lout, Cout)).astype(
        np.float32)).to(card, dtype)
    return flat[offset:].view(B, L, Cin), dz


def _dw_case(x, dz, K, stride, has_bias):
    """dw and db from one launch (counted; two calls bitwise equal) against
    the plain version within TOL of the largest value (phase 7's scaled
    TOL). Returns the plan and x's copy width."""
    before = tsb.conv1d_bwd_dw.launches
    dw, db = tsb.conv1d_bwd_dw(x, dz, K, stride=stride, has_bias=has_bias)
    assert tsb.conv1d_bwd_dw.launches == before + 1
    dw2, db2 = tsb.conv1d_bwd_dw(x, dz, K, stride=stride, has_bias=has_bias)
    assert torch.equal(dw, dw2)
    want_dw, want_db = tsb.conv1d_bwd_dw_plain(x, dz, K, stride=stride,
                                               has_bias=has_bias)
    pairs = [(dw, want_dw)]
    if has_bias:
        assert torch.equal(db, db2)
        pairs.append((db, want_db))
    else:
        assert db is None
    for got, want in pairs:
        assert got.dtype == torch.float32
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale)
    Cin = x.shape[2]
    plan, va, _, _ = tsb.dw_launch(x.contiguous(), dz.contiguous(), K * Cin,
                                   x.shape[1], Cin, K, stride, has_bias)
    return plan, va


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,Cin,Cout,K,stride", DW_SHAPES)
def test_dw_kernel_matches_plain(card, forced_splits, B, L, Cin, Cout, K,
                                 stride, dtype, splits):
    """Each shape with the plan's split and forced to 1 and 3 splits
    (float32 partials of dw and db added in split order), db on and off by
    the shape's place in the list."""
    if splits:
        forced_splits(splits)
    i = DW_SHAPES.index((B, L, Cin, Cout, K, stride))
    x, dz = _dw_inputs(card, 70 + i, B, L, Cin, Cout, K, stride,
                       getattr(torch, dtype))
    plan, va = _dw_case(x, dz, K, stride, has_bias=i % 2 == 0)
    if splits:
        assert (plan.splits > 1) == (splits > 1 and plan.chunks > 1)
    elif Cin == 80:  # whisper's conv1: 16 tiles, split
        assert plan.splits > 1 and va == 16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,va", [("float32", 4), ("bfloat16", 2)])
@pytest.mark.parametrize("Cin,stride", [(80, 1), (1024, 2)])
def test_dw_unaligned_base(card, Cin, stride, dtype, va):
    """x one element past its storage's 16-byte alignment: the copies
    narrow to the pointer's alignment, the result does not move."""
    x, dz = _dw_inputs(card, Cin + stride, 2, 131, Cin, 70, 3, stride,
                       getattr(torch, dtype), offset=1)
    _, got_va = _dw_case(x, dz, 3, stride, has_bias=True)
    assert got_va == va
