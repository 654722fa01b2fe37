# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# single real CPU device; only launch/dryrun.py forces 512 virtual devices
# (and multi-device tests spawn subprocesses that set their own flags).
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _hermetic_autotune_cache(tmp_path, monkeypatch):
    """Point the kernel autotuner at an empty per-test cache so a stray
    .cache/autotune.json in the working tree can't steer test tilings.
    (test_autotune overrides the env var again inside its own fixture.)"""
    from repro.kernels import autotune

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune.invalidate()
    yield
    autotune.invalidate()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA kernels); skipped without one")
