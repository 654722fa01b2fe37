"""The 1-D sliding conv kernel (row 1, ``csrc/sliding_conv1d.cu``, one
product on ``csrc/gemm_mma.cuh``'s loop) against its plain version, on the
card: filters of 1 to 2049 taps (a halo no block's shared memory holds),
strides 1-3, Cin 3, 37, 80 and 1024 (copies of x 4 to 16 bytes wide, and
2-byte plain loads in bf16), every activation with and without bias, y and
the saved pre-activation z, the plan's split of the reduction and forced
splits of 1 and 3, x one element off its storage's alignment, whisper's
frontend at full width; one launch a call, two calls bitwise equal.

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
