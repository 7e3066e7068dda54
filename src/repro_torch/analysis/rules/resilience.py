"""Resilience rule (RS...).

The retry layer is safe because every retry decision funnels
through ONE predicate (``repro_torch.serving.resilience.is_retryable``,
a copy of the JAX package's): 503
admission control and transient transport failures are retried,
malformed requests and maxMpR violations are not. A hand-rolled retry
loop that pattern-matches exceptions itself will eventually retry a
permanent error forever (or drop a transient one), and a transport
error swallowed without a trace is an availability bug that never shows
up in metrics. RS001 pins both shapes down statically:

* an ``except`` for a transport-family exception (``TransportError``,
  ``InjectedFault``, ``QueueSaturated``, ``DeadlineExceeded``) inside a
  retry loop (a ``while`` loop, or a ``for`` over ``range(...)`` --
  the bounded-attempt idioms) must consult ``is_retryable`` somewhere
  in that loop;
* any such handler, loop or not, must not swallow silently: its body
  must re-raise, reference the bound exception, or record a counter
  (an augmented assignment or a ``record*``/``append``/``add`` call) --
  so every absorbed failure leaves a trace the metrics can surface.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from ..engine import AnalysisContext
from ..findings import SEVERITY_ERROR, Finding
from . import Rule

# Exception names whose handlers RS001 audits. Matched on the last
# dotted component, so ``faults.InjectedFault`` triggers too. Plain
# TimeoutError is deliberately absent: it guards many non-transport
# waits and would drown the rule in false positives.
_TRANSPORT_EXCEPTIONS = {"TransportError", "InjectedFault",
                         "QueueSaturated", "DeadlineExceeded"}

_RECORDING_METHODS = ("record", "append", "add", "put", "set_exception")


def _exception_names(node: Optional[ast.expr]) -> Set[str]:
    """Last dotted component of every exception named by an except
    clause (handles ``except X``, ``except pkg.X``, ``except (X, Y)``;
    a bare ``except:`` audits nothing -- it is someone else's problem)."""
    if node is None:
        return set()
    if isinstance(node, ast.Tuple):
        out: Set[str] = set()
        for elt in node.elts:
            out |= _exception_names(elt)
        return out
    if isinstance(node, ast.Name):
        return {node.id}
    if isinstance(node, ast.Attribute):
        return {node.attr}
    return set()


def _mentions_name(nodes, name: str) -> bool:
    for stmt in nodes:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and node.id == name:
                return True
    return False


def _records_failure(handler: ast.ExceptHandler) -> bool:
    """Does the handler leave a trace? Re-raise, touch the bound
    exception, bump a counter, or call a recording method."""
    for stmt in handler.body:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Raise, ast.AugAssign)):
                return True
            if (handler.name is not None and isinstance(node, ast.Name)
                    and node.id == handler.name):
                return True
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr.startswith(_RECORDING_METHODS)):
                return True
    return False


def _is_retry_loop(node: ast.AST) -> bool:
    """The bounded-attempt loop idioms: ``while ...`` or
    ``for _ in range(...)``."""
    if isinstance(node, ast.While):
        return True
    if isinstance(node, ast.For):
        it = node.iter
        return (isinstance(it, ast.Call)
                and isinstance(it.func, ast.Name)
                and it.func.id == "range")
    return False


def _handlers_with_loops(tree: ast.AST):
    """Yield (handler, enclosing retry loop or None), outermost loop
    first, without descending into nested function definitions twice
    (every def gets its own walk from the module root -- the loop stack
    resets at def boundaries, since a closure's loop is not the def's)."""
    stack: List[Tuple[ast.AST, Optional[ast.AST]]] = [(tree, None)]
    while stack:
        node, loop = stack.pop()
        if isinstance(node, ast.ExceptHandler):
            yield node, loop
        here = loop
        if _is_retry_loop(node):
            here = node
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
            here = None
        for child in ast.iter_child_nodes(node):
            stack.append((child, here))


def check_retry_discipline(ctx: AnalysisContext) -> List[Finding]:
    """RS001: retry loops consult ``is_retryable``; transport-error
    handlers never swallow silently."""
    findings: List[Finding] = []
    for mod in ctx.modules:
        for handler, loop in _handlers_with_loops(mod.tree):
            caught = _exception_names(handler.type) & _TRANSPORT_EXCEPTIONS
            if not caught:
                continue
            names = "/".join(sorted(caught))
            if loop is not None and not _mentions_name([loop],
                                                       "is_retryable"):
                findings.append(Finding(
                    file=mod.rel, line=handler.lineno,
                    col=handler.col_offset, rule="RS001",
                    severity=SEVERITY_ERROR,
                    message=(f"retry loop catches {names} without "
                             "consulting the central is_retryable() "
                             "predicate (repro.serving.resilience) -- "
                             "blind retries eventually retry permanent "
                             "errors")))
            elif not _records_failure(handler):
                findings.append(Finding(
                    file=mod.rel, line=handler.lineno,
                    col=handler.col_offset, rule="RS001",
                    severity=SEVERITY_ERROR,
                    message=(f"except {names} swallows the failure "
                             "silently: re-raise, reference the bound "
                             "exception, or record a counter so the "
                             "metrics surface it")))
    return findings


RULES = [
    Rule("RS001", "retry loops use is_retryable(); no silent "
                  "transport-error swallows", check_retry_discipline),
]
