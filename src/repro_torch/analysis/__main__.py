"""CLI entry point: ``python -m repro_torch.analysis [paths...]``.

Exit status is 1 when any error-severity finding (or parse failure)
is reported, 0 on a clean tree -- CI and scripts/verify.sh key off
that. ``--format json`` emits a machine-readable report. Both formats
also list the inventory of CUDA entries (``cuda_entries``): each
``lib.brtpf_*`` launch with its wrapper, C symbol and ``.cu`` source.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .engine import load_context, run_analysis
from .findings import SEVERITY_ERROR
from .rules import ALL_RULES
from .rules.cuda_launch import cuda_entries


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=("repro-lint: static enforcement of the repo's "
                     "kernel-launch, cache-coherence, accounting, and "
                     "async-safety invariants"))
    parser.add_argument(
        "paths", nargs="*",
        help=("files or directories to analyze (default: the repo's "
              "src/ and benchmarks/ trees)"))
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="output format (default: text)")
    parser.add_argument(
        "--select", default="",
        help="comma-separated rule ids to run (default: all)")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="list rule ids and summaries, then exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.rule_id}  {rule.summary}")
        return 0

    select = [r.strip() for r in args.select.split(",") if r.strip()] \
        or None
    known = {rule.rule_id for rule in ALL_RULES}
    if select:
        unknown = [r for r in select if r not in known]
        if unknown:
            parser.error(f"unknown rule id(s): {', '.join(unknown)}")

    ctx = load_context(args.paths)
    findings = run_analysis(ctx, select=select)
    errors = [f for f in findings if f.severity == SEVERITY_ERROR]
    entries = [{"function": e.function, "module": e.module.rel,
                "line": e.node.lineno, "symbol": e.symbol,
                "source": e.source} for e in cuda_entries(ctx)]

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "counts": {
                "total": len(findings),
                "error": len(errors),
                "modules": len(ctx.modules),
            },
            "cuda_entries": entries,
        }, indent=2))
    else:
        for finding in findings:
            print(finding.format())
        for e in entries:
            print(f"cuda entry {e['module']}:{e['line']} {e['function']} "
                  f"-> {e['symbol']} ({e['source']})")
        print(f"{len(findings)} finding(s) ({len(errors)} error) "
              f"across {len(ctx.modules)} module(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
