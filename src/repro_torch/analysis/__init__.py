"""Static analysis of the port's kernels and dispatch layer, counterpart of
``repro.analysis``.

Five passes, run by ``python -m repro_torch.analysis``:

  * :mod:`repro_torch.analysis.contracts`: every CUDA launcher's launch
    (grid, threads, dynamic shared memory, the blocks an SM is meant to
    hold, the split scheme, each operand's copies) is
    rebuilt from the port's plan functions and proved over the tuning
    key space against the H100's limits; the tuning searches prune on the
    same verdicts.
  * :mod:`repro_torch.analysis.costmodel`: a roofline on the H100,
    ``max(ops / peak, hbm / bw, smem / smem_bw)`` quantised by waves, for
    every contract instance; the tuning searches rank their candidates on
    it, and it is validated (MAPE, Spearman ρ) against the tuning cache.
  * :mod:`repro_torch.analysis.ranges`: interval proofs over the int8
    chains (int32 accumulators, requant codes, KV scale folds).
  * :mod:`repro_torch.analysis.lint`: an AST lint over
    ``src/repro_torch`` for the frozen registries (health reasons, sites,
    obs names, the ladder's key, no wall clock in duration paths).
  * :mod:`repro_torch.analysis.bloat`: the α-rule over the plain rungs,
    traced with ``make_fx`` under ``FakeTensorMode``, and the dequant
    count of each requant chain.
"""
from repro_torch.analysis.contracts import (  # noqa: F401
    KernelInstance,
    Violation,
    check_all,
    check_autotune_candidate,
    check_instance,
    smem_budget,
)
