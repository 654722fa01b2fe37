"""The selective-SSM scan of the PyTorch port against the JAX reference, on
the CPU: ``ssm_scan`` (its plain version on a CPU tensor) against the
reference's Pallas kernel ``ssm_scan_pallas`` in interpret mode and its
oracle ``ssm_scan_ref``, at the shapes of ``tests/test_kernels.py``. The
kernel itself is held to the plain version on the card by
``tests/test_torch_pool_card.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan import ssm_scan_pallas, ssm_scan_ref  # noqa: E402
from repro_torch.kernels import ssm_scan as tss  # noqa: E402

# the reference's tolerance for the scan (tests/test_kernels.py)
TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, B, L, D, N, lo=0.3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, 1.0, size=(B, L, D, N)).astype(np.float32),
            rng.normal(size=(B, L, D, N)).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32),
            rng.normal(size=(B, D, N)).astype(np.float32))


def _close_scaled(got, want, rtol, atol_frac):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_frac * scale)


@pytest.mark.parametrize(
    "B,L,D,N,td,cl",
    [(2, 64, 32, 8, 16, 16), (1, 100, 48, 4, 32, 32),
     (2, 256, 64, 16, 64, 128), (1, 37, 24, 8, 16, 16)],
)
def test_ssm_scan_matches_reference_kernel(B, L, D, N, td, cl):
    arrays = _inputs(L + D, B, L, D, N)
    y, h = tss.ssm_scan(*(torch.from_numpy(a) for a in arrays))
    j = [jnp.asarray(a) for a in arrays]
    y1, h1 = ssm_scan_pallas(*j, tile_d=td, chunk_l=cl, interpret=True)
    y2, h2 = ssm_scan_ref(*j)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert tuple(y.shape) == (B, L, D) and tuple(h.shape) == (B, D, N)
    for yw, hw in ((y1, h1), (y2, h2)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yw), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(hw), **TOL)


def test_ssm_scan_bf16_matches_reference_kernel():
    """bfloat16 inputs are widened, the state is float32, y is rounded
    once to bfloat16; h0 zero, as in the reference's test."""
    B, L, D, N = 1, 64, 32, 8
    a, u, c, _ = _inputs(5, B, L, D, N, lo=0.5)
    h0 = np.zeros((B, D, N), np.float32)
    ja = [jnp.asarray(v).astype(jnp.bfloat16) for v in (a, u, c)]
    ta = [torch.from_numpy(v).to(torch.bfloat16) for v in (a, u, c)]
    y, h = tss.ssm_scan(*ta, torch.from_numpy(h0))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y1, h1 = ssm_scan_pallas(*ja, jnp.asarray(h0), tile_d=16, chunk_l=16,
                             interpret=True)
    y2, h2 = ssm_scan_ref(*ja, jnp.asarray(h0))
    for yw, hw in ((y1, h1), (y2, h2)):
        _close_scaled(y.float().numpy(), np.asarray(yw.astype(jnp.float32)),
                      rtol=5e-2, atol_frac=5e-2)
        np.testing.assert_allclose(h.numpy(), np.asarray(hw), **TOL)


@pytest.mark.parametrize("L", [1, 2, 37])
@pytest.mark.parametrize("N", [1, 4, 16, 20])
def test_ssm_scan_edges_match_reference_oracle(L, N):
    """Any L (one position included) and any state width on the CPU."""
    arrays = _inputs(L * N, 2, L, 5, N)
    y, h = tss.ssm_scan(*(torch.from_numpy(a) for a in arrays))
    y2, h2 = ssm_scan_ref(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(y.numpy(), np.asarray(y2), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h2), **TOL)


def test_ssm_scan_refuses_bad_shapes_and_devices():
    a = torch.zeros(1, 4, 3, 2)
    c, h0 = torch.zeros(1, 4, 2), torch.zeros(1, 3, 2)
    with pytest.raises(ValueError, match="are not two"):
        tss.ssm_scan(a, torch.zeros(1, 4, 3, 3), c, h0)
    with pytest.raises(ValueError, match="are not"):
        tss.ssm_scan(a, a, torch.zeros(1, 4, 3), h0)
    with pytest.raises(ValueError, match="L >= 1"):
        tss.ssm_scan(a[:, :0], a[:, :0], c[:, :0], h0)
    with pytest.raises(ValueError, match="no ssm_scan for device"):
        tss.ssm_scan(*(torch.empty(t.shape, device="meta")
                       for t in (a, a, c, h0)))
    before = tss.ssm_scan.launches
    tss.ssm_scan(a, a, c, h0)
    assert tss.ssm_scan.launches == before
