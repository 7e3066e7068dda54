"""Cache-coherence rules (CC...).

The unified ``FragmentStore`` made one layer responsible for
keeping the selector memo, range memo, and HTTP page cache coherent
with the underlying ``TripleStore`` pages: eviction releases flow
through ``on_release`` so candidate-range spans die with the cache
entries that justified materializing them. Two conventions keep that
true and both are purely social without this pass: store internals stay
inside ``fragments.py``, and any code path that mutates triple/pattern
data must reach an invalidation.
"""
from __future__ import annotations

import ast
from typing import List

from ..engine import AnalysisContext
from ..findings import SEVERITY_ERROR, Finding
from . import Rule

# FragmentStore-private structures. (LRUCache in cache.py has its own
# unrelated ``_entries``, so that name is intentionally not listed.)
_FRAGMENT_INTERNALS = {"_data_lru", "_page_lru", "_pattern_refs"}
_FRAGMENTS_FILE = "fragments.py"

# Attributes whose (re)assignment counts as mutating triple-pattern
# data backing cached ranges.
_MUTATED_ATTRS = {"triples", "_indexes"}

# Attributes whose (re)assignment constitutes a placement cutover: a
# server swapping its FederatedStore (docs/federation.md, "Placement")
# serves the same key ranges from new shard boundaries, so every cached
# fragment/range must be invalidated with the swap.
_CUTOVER_ATTRS = {"federated"}

# Call names that constitute (or lead to) cache invalidation.
_INVALIDATION_SINKS = {"on_release", "evict", "evict_page",
                       "evict_candidate_range", "clear", "invalidate",
                       "trim"}


def check_fragmentstore_internals(ctx: AnalysisContext) -> List[Finding]:
    """CC001: FragmentStore internals are not reached into from
    outside fragments.py."""
    findings: List[Finding] = []
    for mod in ctx.modules:
        if mod.filename == _FRAGMENTS_FILE:
            continue
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Attribute)
                    and node.attr in _FRAGMENT_INTERNALS):
                findings.append(Finding(
                    file=mod.rel, line=node.lineno, col=node.col_offset,
                    rule="CC001", severity=SEVERITY_ERROR,
                    message=(f"access to FragmentStore internal "
                             f"'{node.attr}' outside fragments.py; go "
                             "through the public evict/on_release/"
                             "stats API so coherence accounting stays "
                             "centralized")))
    return findings


def _mutations(func_node: ast.AST,
               attrs=frozenset(_MUTATED_ATTRS)) -> List[ast.stmt]:
    """Statements in ``func_node`` that rebind or store into an
    attribute named in ``attrs``."""
    hits: List[ast.stmt] = []
    for node in ast.walk(func_node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not func_node:
            continue
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for tgt in targets:
            if (isinstance(tgt, ast.Attribute)
                    and tgt.attr in attrs):
                hits.append(node)
            elif (isinstance(tgt, ast.Subscript)
                  and isinstance(tgt.value, ast.Attribute)
                  and tgt.value.attr in attrs):
                hits.append(node)
    return hits


def check_mutation_invalidation(ctx: AnalysisContext) -> List[Finding]:
    """CC002: a function mutating TripleStore data must reach a
    FragmentStore invalidation in the call graph. ``__init__`` is
    exempt (construction precedes any cache entries)."""
    findings: List[Finding] = []
    graph = ctx.callgraph()
    for info in graph.functions.values():
        if info.name == "__init__":
            continue
        hits = _mutations(info.node)
        if not hits:
            continue
        if graph.reaches(info, _INVALIDATION_SINKS):
            continue
        for stmt in hits:
            findings.append(Finding(
                file=info.module.rel, line=stmt.lineno,
                col=stmt.col_offset, rule="CC002",
                severity=SEVERITY_ERROR,
                message=(f"'{info.name}' mutates triple-pattern data "
                         "but no FragmentStore invalidation "
                         "(on_release/evict/clear) is reachable from "
                         "it; cached candidate ranges would go "
                         "stale")))
    return findings


def check_repartition_invalidation(ctx: AnalysisContext) -> List[Finding]:
    """CC003: a placement cutover (rebinding a ``.federated`` store)
    must reach a FragmentStore invalidation in the call graph.

    The repartitioned store serves identical fragments from new shard
    boundaries, but cached pages/ranges were computed (and accounted)
    against the old ones -- a swap that keeps them resident would serve
    stale residency decisions after cutover. ``__init__`` is exempt
    (first construction precedes any cache entries)."""
    findings: List[Finding] = []
    graph = ctx.callgraph()
    for info in graph.functions.values():
        if info.name == "__init__":
            continue
        hits = _mutations(info.node, attrs=_CUTOVER_ATTRS)
        if not hits:
            continue
        if graph.reaches(info, _INVALIDATION_SINKS):
            continue
        for stmt in hits:
            findings.append(Finding(
                file=info.module.rel, line=stmt.lineno,
                col=stmt.col_offset, rule="CC003",
                severity=SEVERITY_ERROR,
                message=(f"'{info.name}' swaps a federated store "
                         "(placement cutover) but no FragmentStore "
                         "invalidation (on_release/evict/clear) is "
                         "reachable from it; fragments cached against "
                         "the old shard boundaries would stay "
                         "resident")))
    return findings


RULES = [
    Rule("CC001", "FragmentStore internals stay inside fragments.py",
         check_fragmentstore_internals),
    Rule("CC002", "data mutation reaches cache invalidation",
         check_mutation_invalidation),
    Rule("CC003", "placement cutover reaches cache invalidation",
         check_repartition_invalidation),
]
