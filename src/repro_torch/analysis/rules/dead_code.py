"""Dead-code rules (DC...).

Unreachable statements and dead stores are how accounting bugs hide:
a counter increment after a ``continue``, or a recomputed buffer whose
first computation was already charged to a cost model. These two rules
keep the tree free of both shapes.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from ..engine import AnalysisContext
from ..findings import SEVERITY_ERROR, Finding
from . import Rule

_TERMINATORS = (ast.Return, ast.Raise, ast.Break, ast.Continue)

# Call targets considered pure for the duplicate-store rule: value
# constructors whose result depends only on their (pure) arguments.
_PURE_CALLS = {"empty", "zeros", "ones", "full", "array", "asarray",
               "arange", "int", "float", "tuple", "list", "dict", "set",
               "frozenset", "len", "max", "min", "abs"}


def _stmt_lists(tree: ast.AST):
    for node in ast.walk(tree):
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if isinstance(stmts, list) and stmts \
                    and all(isinstance(s, ast.stmt) for s in stmts):
                yield node, stmts


def check_unreachable(ctx: AnalysisContext) -> List[Finding]:
    """DC001: statements after return/raise/break/continue, and
    branches dead under a constant test."""
    findings: List[Finding] = []
    for mod in ctx.modules:
        for _, stmts in _stmt_lists(mod.tree):
            for i, stmt in enumerate(stmts[:-1]):
                if isinstance(stmt, _TERMINATORS):
                    nxt = stmts[i + 1]
                    findings.append(Finding(
                        file=mod.rel, line=nxt.lineno,
                        col=nxt.col_offset, rule="DC001",
                        severity=SEVERITY_ERROR,
                        message=("unreachable code after "
                                 f"'{type(stmt).__name__.lower()}'")))
                    break
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.If) \
                    and isinstance(node.test, ast.Constant):
                dead = node.orelse if node.test.value else node.body
                if dead:
                    findings.append(Finding(
                        file=mod.rel, line=dead[0].lineno,
                        col=dead[0].col_offset, rule="DC001",
                        severity=SEVERITY_ERROR,
                        message=("branch is dead: if-test is the "
                                 f"constant {node.test.value!r}")))
            elif isinstance(node, ast.While) \
                    and isinstance(node.test, ast.Constant) \
                    and not node.test.value and node.body:
                findings.append(Finding(
                    file=mod.rel, line=node.body[0].lineno,
                    col=node.body[0].col_offset, rule="DC001",
                    severity=SEVERITY_ERROR,
                    message="while-body is dead: test is constant false"))
    return findings


def _is_pure_value(node: ast.expr) -> bool:
    if isinstance(node, (ast.Constant, ast.Name)):
        return True
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_pure_value(e) for e in node.elts)
    if isinstance(node, ast.UnaryOp):
        return _is_pure_value(node.operand)
    if isinstance(node, ast.BinOp):
        return _is_pure_value(node.left) and _is_pure_value(node.right)
    if isinstance(node, ast.Attribute):
        return _is_pure_value(node.value)
    if isinstance(node, ast.Call):
        name = node.func.attr if isinstance(node.func, ast.Attribute) \
            else (node.func.id if isinstance(node.func, ast.Name) else "")
        if name not in _PURE_CALLS:
            return False
        return (all(_is_pure_value(a) for a in node.args)
                and all(kw.value is not None
                        and _is_pure_value(kw.value)
                        for kw in node.keywords))
    return False


def _disqualified_names(func: ast.AST) -> Set[str]:
    """Local names whose value may change through aliasing or in-place
    mutation between two textual assignments."""
    out: Set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                if isinstance(tgt, (ast.Subscript, ast.Attribute)) \
                        and isinstance(tgt.value, ast.Name):
                    out.add(tgt.value.id)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name):
            out.add(node.func.value.id)   # method call may mutate
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            out.update(node.names)
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
        elif isinstance(node, (ast.For, ast.comprehension)):
            tgt = node.target
            for leaf in ast.walk(tgt):
                if isinstance(leaf, ast.Name):
                    out.add(leaf.id)
    return out


def _rebound_names(func: ast.AST) -> Set[str]:
    """Names (re)bound anywhere in the function body -- a value
    expression referencing one of these can differ between two
    textually identical assignments."""
    out: Set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                for leaf in ast.walk(tgt):
                    if isinstance(leaf, ast.Name):
                        out.add(leaf.id)
        elif isinstance(node, (ast.For, ast.comprehension)):
            for leaf in ast.walk(node.target):
                if isinstance(leaf, ast.Name):
                    out.add(leaf.id)
        elif isinstance(node, ast.withitem) and node.optional_vars:
            for leaf in ast.walk(node.optional_vars):
                if isinstance(leaf, ast.Name):
                    out.add(leaf.id)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            out.add(node.name)
        elif isinstance(node, ast.NamedExpr) \
                and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def check_duplicate_stores(ctx: AnalysisContext) -> List[Finding]:
    """DC002: the same name assigned the same pure value twice,
    unconditionally, within one function -- the second store is dead
    (or the first is, either way one of them shouldn't exist)."""
    findings: List[Finding] = []
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            disqualified = _disqualified_names(node)
            rebound = _rebound_names(node)
            seen: Dict[Tuple[str, str], int] = {}
            for stmt in node.body:      # unconditional positions only
                if not (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)):
                    continue
                name = stmt.targets[0].id
                if name in disqualified or not _is_pure_value(stmt.value):
                    continue
                refs = {leaf.id for leaf in ast.walk(stmt.value)
                        if isinstance(leaf, ast.Name)}
                if refs & rebound:
                    continue            # operands may change in between
                key = (name, ast.dump(stmt.value))
                if key in seen:
                    findings.append(Finding(
                        file=mod.rel, line=stmt.lineno,
                        col=stmt.col_offset, rule="DC002",
                        severity=SEVERITY_ERROR,
                        message=(f"duplicate assignment to '{name}' "
                                 "with an identical value (first at "
                                 f"line {seen[key]}); the second "
                                 "store is dead")))
                else:
                    seen[key] = stmt.lineno
    return findings


RULES = [
    Rule("DC001", "no unreachable statements or dead branches",
         check_unreachable),
    Rule("DC002", "no duplicate unconditional pure stores",
         check_duplicate_stores),
]
