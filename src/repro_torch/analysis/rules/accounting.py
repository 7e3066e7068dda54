"""Accounting-integrity rules (AC...).

The paper's evaluation is its request/transfer counts, and the repo's
launch-budget gates regress on them -- so every launch
must be charged somewhere, exactly once, and every budget key must
name a metric that actually exists. Three rules:

* AC001 -- a ``LaunchRecord`` that is constructed but never appended to
  a ``launches`` accounting surface is a launch the server will never
  charge;
* AC002 -- in a disposition chain over launch records (testing
  ``.skipped`` / ``.fast_path``), every path must increment exactly one
  of the launch counters (``kernel_launches`` / ``fast_path_selects``
  / ``launches_skipped``) -- zero drops the launch from the ledger, two
  double-charges it;
* AC003 -- every ``benchmarks/budgets.json`` key must resolve to a
  metric ``core/metrics.py`` emits, otherwise the budget gate
  silently gates nothing.
"""
from __future__ import annotations

import ast
import json
from typing import List, Sequence, Set

from ..engine import AnalysisContext
from ..findings import SEVERITY_ERROR, Finding
from . import Rule

# Counter fields that charge a launch disposition. ``launches`` covers
# the generic name; the live Counters field is ``kernel_launches``.
_DISPOSITION_COUNTERS = {"launches", "kernel_launches",
                         "fast_path_selects", "launches_skipped"}
_DISPOSITION_FLAGS = {"skipped", "fast_path"}

_ACCOUNTING_SURFACE = "launches"


def _is_launchrecord_call(node: ast.expr) -> bool:
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    name = func.id if isinstance(func, ast.Name) else (
        func.attr if isinstance(func, ast.Attribute) else "")
    return name == "LaunchRecord"


def check_launchrecord_sink(ctx: AnalysisContext) -> List[Finding]:
    """AC001: every LaunchRecord construction is appended to a
    ``launches`` list at the construction site."""
    findings: List[Finding] = []
    for mod in ctx.modules:
        accounted: Set[int] = set()
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "append"):
                continue
            recv = node.func.value
            recv_name = recv.id if isinstance(recv, ast.Name) else (
                recv.attr if isinstance(recv, ast.Attribute) else "")
            if recv_name != _ACCOUNTING_SURFACE:
                continue
            for arg in node.args:
                if _is_launchrecord_call(arg):
                    accounted.add(id(arg))
        for node in ast.walk(mod.tree):
            if _is_launchrecord_call(node) and id(node) not in accounted:
                findings.append(Finding(
                    file=mod.rel, line=node.lineno, col=node.col_offset,
                    rule="AC001", severity=SEVERITY_ERROR,
                    message=("LaunchRecord constructed outside a "
                             "'launches.append(...)' accounting sink; "
                             "this launch will never be charged to "
                             "Counters")))
    return findings


def _mentions_disposition(test: ast.expr) -> bool:
    return any(isinstance(n, ast.Attribute)
               and n.attr in _DISPOSITION_FLAGS
               for n in ast.walk(test))


def _terminates(stmts: Sequence[ast.stmt]) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Continue, ast.Break, ast.Return, ast.Raise))


def _split_paths(stmts: Sequence[ast.stmt]) -> List[List[ast.stmt]]:
    """Execution paths through a statement list, branching at each
    disposition test. Guard-with-continue chains and if/elif/else
    ladders both come out as one path per disposition."""
    stmts = list(stmts)
    for i, stmt in enumerate(stmts):
        if isinstance(stmt, ast.If) and _mentions_disposition(stmt.test):
            pre, rest = stmts[:i], stmts[i + 1:]
            taken = pre + list(stmt.body)
            if not _terminates(stmt.body):
                taken = taken + rest
            paths = [taken]
            for tail in _split_paths(pre + list(stmt.orelse) + rest):
                paths.append(tail)
            return paths
    return [stmts]


def _count_disposition_increments(stmts: Sequence[ast.stmt]) -> int:
    count = 0
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if (isinstance(node, ast.AugAssign)
                    and isinstance(node.target, ast.Attribute)
                    and node.target.attr in _DISPOSITION_COUNTERS):
                count += 1
    return count


def check_disposition_paths(ctx: AnalysisContext) -> List[Finding]:
    """AC002: each path through a launch-disposition chain increments
    exactly one disposition counter."""
    findings: List[Finding] = []
    graph = ctx.callgraph()
    for info in graph.functions.values():
        for node in ast.walk(info.node):
            if not isinstance(node, ast.For):
                continue
            has_disposition = any(
                isinstance(n, ast.If) and _mentions_disposition(n.test)
                for n in ast.walk(node))
            if not has_disposition:
                continue
            if _count_disposition_increments(node.body) == 0:
                continue                  # not an accounting loop
            for path in _split_paths(node.body):
                n = _count_disposition_increments(path)
                if n != 1:
                    anchor = path[0] if path else node
                    findings.append(Finding(
                        file=info.module.rel, line=anchor.lineno,
                        col=anchor.col_offset, rule="AC002",
                        severity=SEVERITY_ERROR,
                        message=(f"launch-disposition path in "
                                 f"'{info.name}' increments {n} "
                                 "disposition counters (expected "
                                 "exactly 1 of kernel_launches/"
                                 "fast_path_selects/"
                                 "launches_skipped)")))
    return findings


def _emitted_metric_names(ctx: AnalysisContext) -> Set[str]:
    """Metric names core/metrics.py emits: Counters field names plus
    every string key of a dict literal in the module."""
    names: Set[str] = set()
    for mod in ctx.modules_named("metrics.py"):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and node.name == "Counters":
                for stmt in node.body:
                    if (isinstance(stmt, ast.AnnAssign)
                            and isinstance(stmt.target, ast.Name)):
                        names.add(stmt.target.id)
            if isinstance(node, ast.Dict):
                for key in node.keys:
                    if (isinstance(key, ast.Constant)
                            and isinstance(key.value, str)):
                        names.add(key.value)
    return names


def _budget_key_line(source: str, key: str) -> int:
    for i, line in enumerate(source.splitlines(), start=1):
        if f'"{key}"' in line:
            return i
    return 1


def check_budget_keys(ctx: AnalysisContext) -> List[Finding]:
    """AC003: every budgets.json key resolves to an emitted metric."""
    if ctx.budgets_path is None:
        return []
    emitted = _emitted_metric_names(ctx)
    if not emitted:
        return []                         # no metrics module in scope
    try:
        source = ctx.budgets_path.read_text()
        budgets = json.loads(source)
    except (OSError, ValueError) as exc:
        return [Finding(
            file=ctx.budgets_path.name, line=1, col=0, rule="AC003",
            severity=SEVERITY_ERROR,
            message=f"could not load budgets file: {exc}")]

    findings: List[Finding] = []
    rel = ctx.budgets_path.name
    try:
        rel = ctx.budgets_path.relative_to(ctx.root).as_posix()
    except ValueError:
        pass
    for key in budgets:
        metric = key.split(":", 1)[1] if ":" in key else key
        base = metric[:-len("_per_request")] \
            if metric.endswith("_per_request") else metric
        candidates = {metric, base, f"kernel_{base}", f"kernel_{metric}"}
        if candidates & emitted:
            continue
        findings.append(Finding(
            file=rel, line=_budget_key_line(source, key), col=0,
            rule="AC003", severity=SEVERITY_ERROR,
            message=(f"budget key '{key}' does not resolve to any "
                     "metric emitted by core/metrics.py; the budget "
                     "gate would silently pass")))
    return findings


RULES = [
    Rule("AC001", "LaunchRecord lands on the launches accounting surface",
         check_launchrecord_sink),
    Rule("AC002", "each disposition path charges exactly one counter",
         check_disposition_paths),
    Rule("AC003", "budget keys resolve to emitted metrics",
         check_budget_keys),
]
