"""CLI: ``python -m repro_torch.analysis [--contracts|--bloat|--lint|--costmodel|--ranges|--all]``.

Runs the selected passes (all five by default), prints a report, writes
``ANALYSIS.json`` in the reference's schema 2 (each violation's kind,
family, key and detail, and each pass's stats: the tuning prune report,
the cost model's per-family MAPE and Spearman ρ, the chain proofs) and
exits nonzero on any violation.

Report schema: ``SCHEMA = 2`` has a top-level ``"schema"`` key and
``stats.costmodel`` / ``stats.ranges``; schema-1 reports had neither, and
:func:`load_report` reads both, normalising a schema-1 report to
``schema: 1`` with empty sections.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time

SCHEMA = 2


def load_report(path: str) -> dict:
    """Read an ANALYSIS.json of either schema."""
    with open(path) as f:
        report = json.load(f)
    report.setdefault("schema", 1)
    report.setdefault("stats", {})
    for section in ("contracts", "bloat", "lint", "costmodel", "ranges"):
        report["stats"].setdefault(section, {})
    report.setdefault("violations", [])
    report.setdefault("ok", not report["violations"])
    return report


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis of the port: CUDA launch contracts, "
                    "memory bloat, convention lint, the H100 roofline cost "
                    "model, quant-range interval proofs")
    p.add_argument("--all", action="store_true",
                   help="run every pass (default)")
    p.add_argument("--contracts", action="store_true",
                   help="launch contracts over the tuning key space")
    p.add_argument("--bloat", action="store_true",
                   help="bloat lint of the plain rungs + dequant chains")
    p.add_argument("--lint", action="store_true",
                   help="AST convention lint over the repro_torch package")
    p.add_argument("--costmodel", action="store_true",
                   help="roofline predictions over the key space, validated "
                        "against the tuning cache")
    p.add_argument("--ranges", action="store_true",
                   help="interval proofs over the int8 chains")
    p.add_argument("--quick", action="store_true",
                   help="contracts/costmodel/ranges: a sample of the key "
                        "space")
    p.add_argument("--json", default="ANALYSIS.json", metavar="PATH",
                   help="report path (default: %(default)s)")
    p.add_argument("--smem-budget", type=int, default=None, metavar="BYTES",
                   help="shared memory a block may take (default: 232448, "
                        "the H100's opt-in)")
    p.add_argument("--alpha", type=float, default=None,
                   help="bloat threshold (default: 2.0)")
    p.add_argument("--lint-root", default=None, metavar="DIR",
                   help="lint this tree instead of the repro_torch package")
    p.add_argument("--peaks", default=None, metavar="PATH",
                   help="costmodel: peaks file from probe_peaks (default: "
                        "REPRO_TORCH_PEAKS or .cache/peaks_cuda.json; "
                        "absent: the data sheet's)")
    p.add_argument("--autotune-cache", default=None, metavar="PATH",
                   help="costmodel: tuning cache to validate against "
                        "(default: the live cache path)")
    args = p.parse_args(argv)

    selected = (args.contracts or args.bloat or args.lint or args.costmodel
                or args.ranges)
    run_all = args.all or not selected
    violations = []
    stats: dict = {}
    t0 = time.perf_counter()

    if run_all or args.contracts:
        from repro_torch.analysis import contracts

        v, s = contracts.check_all(quick=args.quick, budget=args.smem_budget)
        violations += v
        # what the tuning searches' contract hook would prune per family at
        # this budget (none at the card's own)
        prune: dict[str, list[int]] = collections.defaultdict(lambda: [0, 0])
        for family, shape, cand in contracts.default_space(quick=args.quick):
            prune[family][0] += 1
            if contracts.check_autotune_candidate(
                    family, shape, cand, budget=args.smem_budget) is not None:
                prune[family][1] += 1
        s["autotune_prune"] = {fam: {"candidates": c, "pruned": pr}
                               for fam, (c, pr) in sorted(prune.items())}
        stats["contracts"] = s
        print(f"[analysis] contracts: {s['instances']} instances over "
              f"{len(s['families'])} families at {s['smem_budget']} B a "
              f"block, {len(v)} violation(s)")
        for fam, d in s["autotune_prune"].items():
            if d["pruned"]:
                print(f"[analysis]   prune {fam}: {d['pruned']}/"
                      f"{d['candidates']} candidates over budget")

    if run_all or args.bloat:
        from repro_torch.analysis import bloat

        v, s = bloat.check_all(alpha=args.alpha)
        violations += v
        stats["bloat"] = s
        print(f"[analysis] bloat: {len(s['rungs'])} rungs + "
              f"{len(s['chains'])} chains (alpha={s['alpha']:g}), "
              f"{len(v)} violation(s)")

    if run_all or args.lint:
        from repro_torch.analysis import lint

        v, s = lint.check_all(root=args.lint_root)
        violations += v
        stats["lint"] = s
        print(f"[analysis] lint: {s['files']} files against {s['sites']} "
              f"registered sites, {len(v)} violation(s)")

    if run_all or args.costmodel:
        from repro_torch.analysis import costmodel

        v, s = costmodel.check_all(quick=args.quick, peaks_path=args.peaks,
                                   cache=args.autotune_cache)
        violations += v
        stats["costmodel"] = s
        pk, val = s["peaks"], s["validate"]
        print(f"[analysis] costmodel: {s['instances']} instances, "
              f"{val['rows']} tuned rows validated ({val['skipped']} "
              f"skipped; peaks {pk['tflops']} TFLOP/s, {pk['hbm_gbps']} "
              f"GB/s [{pk['source']}]), {len(v)} violation(s)")
        for fam, d in sorted(val["families"].items()):
            gate = " [gated]" if d["gated"] else ""
            print(f"[analysis]   {fam}: n={d['n']} mape={d['mape']:.2f} "
                  f"spearman={d['spearman']:.2f}{gate}")

    if run_all or args.ranges:
        from repro_torch.analysis import ranges

        v, s = ranges.check_all(quick=args.quick)
        violations += v
        stats["ranges"] = s
        n_safe = sum(1 for c in s["chains"].values()
                     if c["status"] == "safe")
        print(f"[analysis] ranges: {n_safe}/{len(s['chains'])} shipped "
              f"chains proved safe, {s['kernel_stages']} kernel stages (acc "
              f"bits max {s['acc_bits_max']:.1f}/31, overflow at "
              f"reduce_len>={s['overflow_reduce_len']}), "
              f"{len(v)} violation(s)")

    report = {
        "schema": SCHEMA,
        "ok": not violations,
        "violations": [{"kind": v.kind, "family": v.family, "key": v.key,
                        "detail": v.detail} for v in violations],
        "stats": stats,
        "elapsed_s": round(time.perf_counter() - t0, 2),
    }
    with open(args.json, "w") as f:
        json.dump(report, f, indent=2)
    if violations:
        print(f"\n[analysis] FAIL: {len(violations)} violation(s) (report: "
              f"{args.json}):", file=sys.stderr)
        for v in violations:
            print(f"  {v.line()}", file=sys.stderr)
        return 1
    print(f"[analysis] OK: no violations ({report['elapsed_s']}s, report: "
          f"{args.json})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
