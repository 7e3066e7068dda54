"""Async-safety rule (AS...).

The batching layer multiplexes every in-flight brTPF request
onto one event loop; a single blocking call inside an ``async def``
stalls the whole collector window and turns the measured batching win
into serialized latency. Blocking work belongs in the executor
(``loop.run_in_executor``) -- the analyzer flags direct blocking calls
inside coroutine bodies.
"""
from __future__ import annotations

import ast
from typing import List

from ..engine import AnalysisContext
from ..findings import SEVERITY_ERROR, Finding
from . import Rule

# Fully-dotted call names (and dotted prefixes) that block the loop.
# The serving edge runs every route handler as a coroutine on
# the shared loop, so loop-breaking calls (asyncio.run / uvicorn.run
# re-enter or replace the running loop) and sync HTTP clients are
# flagged alongside the classic sleep/subprocess offenders. Note the
# httpx entries are exact call names, not a prefix: the
# ``httpx.AsyncClient(...)`` constructor is loop-safe and must not
# false-positive.
_BLOCKING_DOTTED = {
    "time.sleep",
    "os.system",
    "os.popen",
    "socket.create_connection",
    "loop.run_until_complete",
    "asyncio.run",
    "uvicorn.run",
    "httpx.get",
    "httpx.post",
    "httpx.request",
}
_BLOCKING_PREFIXES = ("subprocess.", "urllib.request.", "requests.")
_BLOCKING_BARE = {"open", "input"}
# Zero-arg .result() is the concurrent.futures block-until-done idiom.
_BLOCKING_METHOD_NOARGS = {"result"}


def _dotted(node: ast.expr) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        parts.append("")
    return ".".join(reversed(parts))


def _blocking_reason(call: ast.Call) -> str:
    func = call.func
    if isinstance(func, ast.Name):
        if func.id in _BLOCKING_BARE:
            return f"'{func.id}()' performs synchronous I/O"
        return ""
    if not isinstance(func, ast.Attribute):
        return ""
    dotted = _dotted(func)
    if dotted in _BLOCKING_DOTTED:
        return f"'{dotted}()' blocks the event loop"
    if dotted.startswith(_BLOCKING_PREFIXES):
        return f"'{dotted}()' performs synchronous I/O"
    if (func.attr in _BLOCKING_METHOD_NOARGS and not call.args
            and not call.keywords):
        return (f"'.{func.attr}()' blocks until the future resolves; "
                "await it instead")
    return ""


def _walk_coroutine_body(func: ast.AsyncFunctionDef):
    """Yield nodes of the coroutine body, not descending into nested
    function definitions (nested async defs get their own visit)."""
    stack: List[ast.AST] = list(func.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def check_blocking_in_async(ctx: AnalysisContext) -> List[Finding]:
    """AS001: no blocking calls inside ``async def`` bodies."""
    findings: List[Finding] = []
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            for inner in _walk_coroutine_body(node):
                if not isinstance(inner, ast.Call):
                    continue
                reason = _blocking_reason(inner)
                if reason:
                    findings.append(Finding(
                        file=mod.rel, line=inner.lineno,
                        col=inner.col_offset, rule="AS001",
                        severity=SEVERITY_ERROR,
                        message=(f"blocking call inside async def "
                                 f"'{node.name}': {reason} (use "
                                 "loop.run_in_executor or an async "
                                 "equivalent)")))
    return findings


RULES = [
    Rule("AS001", "no blocking calls inside async def bodies",
         check_blocking_in_async),
]
