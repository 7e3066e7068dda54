"""Lightweight intra-package call graph.

Python call targets are not statically resolvable in general, so the
graph over-approximates by *method name*: a call ``x.f(...)`` or
``f(...)`` is an edge to every function named ``f`` anywhere in the
analyzed modules. That is exactly the right bias for reachability
rules like "every mutation reaches an invalidation": over-approximation
can only create false *negatives* for the rule's complement, i.e. it
never flags code that does reach a sink under some resolution.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Set, Tuple

from .engine import Module


@dataclasses.dataclass
class FunctionInfo:
    qualname: str                      # module:Class.method or module:func
    name: str                          # bare function/method name
    module: Module
    node: ast.AST                      # FunctionDef | AsyncFunctionDef
    calls: Set[str]                    # bare names of call targets


class CallGraph:
    def __init__(self) -> None:
        self.functions: Dict[str, FunctionInfo] = {}
        self.by_name: Dict[str, List[FunctionInfo]] = {}

    @classmethod
    def build(cls, modules: Iterable[Module]) -> "CallGraph":
        graph = cls()
        for mod in modules:
            for qual, node in _walk_functions(mod.tree):
                info = FunctionInfo(
                    qualname=f"{mod.rel}:{qual}",
                    name=node.name,
                    module=mod,
                    node=node,
                    calls=_called_names(node),
                )
                graph.functions[info.qualname] = info
                graph.by_name.setdefault(info.name, []).append(info)
        return graph

    def reaches(self, start: FunctionInfo, sinks: Set[str],
                max_depth: int = 12) -> bool:
        """True if any call chain from ``start`` hits a name in
        ``sinks`` (including a direct call)."""
        seen: Set[str] = {start.qualname}
        frontier = [start]
        for _ in range(max_depth):
            next_frontier: List[FunctionInfo] = []
            for info in frontier:
                if info.calls & sinks:
                    return True
                for callee_name in info.calls:
                    for callee in self.by_name.get(callee_name, ()):
                        if callee.qualname not in seen:
                            seen.add(callee.qualname)
                            next_frontier.append(callee)
            if not next_frontier:
                return False
            frontier = next_frontier
        return False


def _walk_functions(tree: ast.Module) -> List[Tuple[str, ast.AST]]:
    out: List[Tuple[str, ast.AST]] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                out.append((qual, child))
                visit(child, qual)
            elif isinstance(child, ast.ClassDef):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                visit(child, qual)

    visit(tree, "")
    return out


def _called_names(func: ast.AST) -> Set[str]:
    """Bare names of every call target in ``func``, nested defs
    included (calling a function that closes over mutation context is
    still part of its behavior)."""
    names: Set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name):
                names.add(node.func.id)
            elif isinstance(node.func, ast.Attribute):
                names.add(node.func.attr)
    return names
