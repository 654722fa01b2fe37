"""The 2-D sliding conv CUDA kernel against its plain version, on the card.

Needs an NVIDIA card and ``nvcc``; skips without a card. It imports neither
jax nor the JAX package, so it runs where the port runs (``--noconftest``:
the suite's conftest imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_conv2d_card.py -m cuda
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import sliding_conv2d as ts2  # noqa: E402

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
