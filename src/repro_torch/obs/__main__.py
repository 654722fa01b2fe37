"""CLI: ``python -m repro_torch.obs report <run_dir>``.

Renders the human summary of a finished run from its persisted
observability artifacts (``metrics.json`` [+ ``trace.json``]) — the
same ``[serve]`` / ``[train]`` lines the live CLIs print, now
reconstructable offline.
"""
from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="observability artifacts: report",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser(
        "report", help="render the run summary from metrics.json"
    )
    rp.add_argument("run_dir", help="directory holding metrics.json")
    args = p.parse_args(argv)

    if args.cmd == "report":
        from repro_torch.obs.report import report

        try:
            report(args.run_dir)
        except FileNotFoundError as e:
            print(f"[obs] {e}", file=sys.stderr)
            return 1
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
