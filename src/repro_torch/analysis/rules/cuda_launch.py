"""CUDA launch rules (KL006-KL008) for the port's hand-written kernels.

The port launches each kernel through ctypes: a wrapper in
``kernels/*.py`` validates its tensors, calls ``lib.brtpf_<name>(...)``
with raw pointers and host integers, and raises if the C function
returns a CUDA error (``build.check``). Nothing in that chain fails
loudly when it is wrong, so three rules hold it in place of the
Pallas-keyed KL001-KL003:

* KL006 -- the ctypes argtypes of each C entry point come from a
  module-level ``SIGNATURES`` table (``kernels/build.py``:
  ``{source: {symbol: argtypes}}``). A tuple one short of the
  ``extern "C"`` signature in ``csrc/<source>.cu`` shifts every later
  argument, and a function with no argtypes gets its pointers truncated
  to C ints; neither raises. Every ``extern "C" int brtpf_*(...)`` must
  have an entry with its parameter count, and every entry its function.
  The ``.cu`` files beside the table's module are read as text: no
  compiler runs.
* KL007 -- every tensor whose ``data_ptr()`` a launch passes must have
  gone through a ``_check*`` helper first (dtype, shape, layout,
  device), and the launch's return code must be bound to a name that
  reaches ``build.check(...)`` (or ``check(...)``) before the function
  returns: a dropped code hides a failed launch.
* KL008 -- two oracles per kernel: every entry is named
  ``<stem>_cuda``, its module defines ``<stem>_plain`` (the CPU path
  and the oracle), and the entry's name occurs in
  ``tests/test_torch_cuda.py``, where it is held against that twin on
  the card. The file is looked for at the analysis root and then at
  each of its ancestors.

A *CUDA entry* is a module-level function whose body calls an attribute
named ``brtpf_*``; :func:`cuda_entries` lists them.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

from ..engine import AnalysisContext, Module, _rel_to
from ..findings import SEVERITY_ERROR, Finding
from . import Rule

_C_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(brtpf_\w+)\s*\(([^)]*)\)')
_C_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_CUDA_TESTS = Path("tests") / "test_torch_cuda.py"
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclasses.dataclass(frozen=True)
class CudaEntry:
    """One launch of a hand-written kernel, in the function making it."""

    function: str                  # the wrapper, e.g. tpf_match_cuda
    module: Module
    symbol: str                    # the C function, e.g. brtpf_tpf_match
    source: Optional[str]          # the csrc/*.cu defining it, root-relative
    node: ast.AST                  # the wrapper's FunctionDef
    call: ast.Call                 # the lib.brtpf_* call


@dataclasses.dataclass(frozen=True)
class _CFunction:
    symbol: str
    params: int
    line: int


def _c_functions(cu: Path) -> List[_CFunction]:
    """The ``extern "C" int brtpf_*`` definitions of a ``.cu`` file."""
    text = _C_COMMENT.sub(lambda m: "\n" * m.group().count("\n"),
                          cu.read_text())
    out = []
    for m in _C_ENTRY.finditer(text):
        params = m.group(2).strip()
        count = 0 if params in ("", "void") else params.count(",") + 1
        out.append(_CFunction(m.group(1), count,
                              text.count("\n", 0, m.start()) + 1))
    return out


def _source_of(ctx: AnalysisContext, mod: Module,
               symbol: str) -> Optional[str]:
    for cu in sorted((mod.path.parent / "csrc").glob("*.cu")):
        if any(c.symbol == symbol for c in _c_functions(cu)):
            return _rel_to(cu, ctx.root)
    return None


def cuda_entries(ctx: AnalysisContext) -> List[CudaEntry]:
    """Every ``lib.brtpf_*`` launch in a module-level function, with
    the C symbol it calls and the ``csrc/*.cu`` file beside its module
    that defines that symbol (None when none does)."""
    entries: List[CudaEntry] = []
    for mod in ctx.modules:
        for func in mod.tree.body:
            if not isinstance(func, _FUNCS):
                continue
            for node in ast.walk(func):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr.startswith("brtpf_")):
                    entries.append(CudaEntry(
                        function=func.name, module=mod,
                        symbol=node.func.attr,
                        source=_source_of(ctx, mod, node.func.attr),
                        node=func, call=node))
    return entries


def _finding(file: str, node, rule: str, message: str) -> Finding:
    return Finding(file=file, line=node.lineno, col=node.col_offset,
                   rule=rule, severity=SEVERITY_ERROR, message=message)


def _signature_tables(ctx: AnalysisContext
                      ) -> Iterator[Tuple[Module, ast.expr, Path]]:
    """(module, SIGNATURES value, csrc dir) of each module that binds
    ``SIGNATURES`` at module level and has a ``csrc/`` beside it."""
    for mod in ctx.modules:
        csrc = mod.path.parent / "csrc"
        if not csrc.is_dir():
            continue
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target, value = stmt.targets[0], stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                target, value = stmt.target, stmt.value
            else:
                continue
            if isinstance(target, ast.Name) and target.id == "SIGNATURES":
                yield mod, value, csrc


def _tuple_len(node: ast.expr) -> Optional[int]:
    """Length of a static tuple expression: literals, ``+`` and
    ``* int``."""
    if isinstance(node, (ast.Tuple, ast.List)):
        if any(isinstance(e, ast.Starred) for e in node.elts):
            return None
        return len(node.elts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left, right = _tuple_len(node.left), _tuple_len(node.right)
        return None if left is None or right is None else left + right
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, times in ((node.left, node.right),
                           (node.right, node.left)):
            if isinstance(times, ast.Constant) and type(times.value) is int:
                n = _tuple_len(seq)
                return None if n is None else n * times.value
    return None


def _str_key(node: Optional[ast.expr]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def check_c_signatures(ctx: AnalysisContext) -> List[Finding]:
    """KL006: each ``SIGNATURES`` table matches the ``extern "C"``
    entry points of the ``csrc/*.cu`` files beside its module."""
    findings: List[Finding] = []
    for mod, table, csrc in _signature_tables(ctx):
        if not isinstance(table, ast.Dict):
            findings.append(_finding(
                mod.rel, table, "KL006",
                "SIGNATURES is not a dict literal; its argtypes cannot be "
                "held against csrc/*.cu"))
            continue
        declared = set()
        for key, per_source in zip(table.keys, table.values):
            source = _str_key(key)
            declared.add(source)
            if source is None or not isinstance(per_source, ast.Dict):
                findings.append(_finding(
                    mod.rel, key or per_source, "KL006",
                    "SIGNATURES entry is not a string key with a dict "
                    "literal of {symbol: argtypes}"))
                continue
            cu = csrc / f"{source}.cu"
            if not cu.is_file():
                findings.append(_finding(
                    mod.rel, key, "KL006",
                    f"SIGNATURES names csrc/{source}.cu, which does not "
                    "exist"))
                continue
            defined = {c.symbol: c for c in _c_functions(cu)}
            listed = set()
            for sym_key, argtypes in zip(per_source.keys,
                                         per_source.values):
                symbol = _str_key(sym_key)
                listed.add(symbol)
                c_fn = defined.get(symbol)
                count = _tuple_len(argtypes)
                if c_fn is None:
                    findings.append(_finding(
                        mod.rel, sym_key or argtypes, "KL006",
                        f"SIGNATURES['{source}'] declares {symbol}, which "
                        f"csrc/{source}.cu does not define as "
                        'extern "C" int'))
                elif count is None:
                    findings.append(_finding(
                        mod.rel, argtypes, "KL006",
                        f"argtypes of {symbol} are not a static tuple "
                        "expression"))
                elif count != c_fn.params:
                    findings.append(_finding(
                        mod.rel, sym_key, "KL006",
                        f"ctypes argtypes of {symbol} have {count} "
                        f"entries but csrc/{source}.cu:{c_fn.line} "
                        f"declares {c_fn.params} parameters -- later "
                        "arguments shift and pointers truncate"))
            for symbol, c_fn in defined.items():
                if symbol not in listed:
                    findings.append(_undeclared(ctx, mod, cu, c_fn))
        for cu in sorted(csrc.glob("*.cu")):
            if cu.stem not in declared:
                findings.extend(_undeclared(ctx, mod, cu, c_fn)
                                for c_fn in _c_functions(cu))
    return findings


def _undeclared(ctx: AnalysisContext, mod: Module, cu: Path,
                c_fn: _CFunction) -> Finding:
    return Finding(
        file=_rel_to(cu, ctx.root), line=c_fn.line, col=0, rule="KL006",
        severity=SEVERITY_ERROR,
        message=(f"{c_fn.symbol} has no SIGNATURES['{cu.stem}'] entry in "
                 f"{mod.rel}: ctypes would pass its arguments without "
                 "argtypes"))


def _pos(node) -> Tuple[int, int]:
    return node.lineno, node.col_offset


def _tail(func: ast.expr) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _bound_name(func: ast.AST, call: ast.Call) -> Optional[str]:
    for node in ast.walk(func):
        if (isinstance(node, ast.Assign) and node.value is call
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            return node.targets[0].id
        if (isinstance(node, ast.AnnAssign) and node.value is call
                and isinstance(node.target, ast.Name)):
            return node.target.id
    return None


def _unchecked_inputs(entry: CudaEntry) -> List[str]:
    """Parameters whose ``data_ptr()`` the launch passes without a
    ``_check*`` call naming them earlier in the function."""
    args = entry.node.args
    params = {a.arg for a in args.posonlyargs + args.args
              + args.kwonlyargs}
    inputs: List[str] = []
    for node in ast.walk(entry.call):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "data_ptr"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in params
                and node.func.value.id not in inputs):
            inputs.append(node.func.value.id)
    checked = set()
    for node in ast.walk(entry.node):
        if (isinstance(node, ast.Call)
                and _tail(node.func).startswith("_check")
                and _pos(node) < _pos(entry.call)):
            checked.update(leaf.id for arg in node.args + [
                kw.value for kw in node.keywords]
                for leaf in ast.walk(arg) if isinstance(leaf, ast.Name))
    return [name for name in inputs if name not in checked]


def _checked_before_return(func: ast.AST, call: ast.Call,
                           name: str) -> bool:
    after = _pos(call)
    returns = [(r.end_lineno, r.end_col_offset) for r in ast.walk(func)
               if isinstance(r, ast.Return) and _pos(r) > after]
    limit = min(returns) if returns else (float("inf"), 0)
    return any(
        isinstance(node, ast.Call) and _tail(node.func) == "check"
        and any(isinstance(a, ast.Name) and a.id == name
                for a in node.args)
        and after < _pos(node) < limit
        for node in ast.walk(func))


def check_launches(ctx: AnalysisContext) -> List[Finding]:
    """KL007: each launch validates its tensor inputs first and checks
    its return code before the function returns."""
    findings: List[Finding] = []
    for entry in cuda_entries(ctx):
        rel, call = entry.module.rel, entry.call
        unchecked = _unchecked_inputs(entry)
        if unchecked:
            findings.append(_finding(
                rel, call, "KL007",
                f"{entry.function} launches {entry.symbol} on "
                f"{', '.join(unchecked)} without a _check* helper "
                "validating them first (dtype, shape, layout, device)"))
        name = _bound_name(entry.node, call)
        if name is None:
            findings.append(_finding(
                rel, call, "KL007",
                f"{entry.function} drops the return code of "
                f"{entry.symbol}: bind it to a name and pass it to "
                "build.check before returning"))
        elif not _checked_before_return(entry.node, call, name):
            findings.append(_finding(
                rel, call, "KL007",
                f"return code '{name}' of {entry.symbol} does not reach "
                f"build.check before {entry.function} returns: a failed "
                "launch would go unnoticed"))
    return findings


def _cuda_tests(root: Path) -> str:
    for base in (root, *root.parents):
        path = base / _CUDA_TESTS
        if path.is_file():
            return path.read_text()
    return ""


def check_two_oracles(ctx: AnalysisContext) -> List[Finding]:
    """KL008: every entry ``<stem>_cuda`` has a ``<stem>_plain`` twin in
    its module and a case in ``tests/test_torch_cuda.py``."""
    findings: List[Finding] = []
    tests = _cuda_tests(ctx.root)
    seen = set()
    for entry in cuda_entries(ctx):
        mod, fn = entry.module, entry.function
        if (mod.rel, fn) in seen:
            continue
        seen.add((mod.rel, fn))
        if not fn.endswith("_cuda"):
            findings.append(_finding(
                mod.rel, entry.node, "KL008",
                f"CUDA entry {fn} is not named <stem>_cuda, so its plain "
                "twin and its card test cannot be found"))
            continue
        plain = fn[:-len("_cuda")] + "_plain"
        if not any(isinstance(stmt, _FUNCS) and stmt.name == plain
                   for stmt in mod.tree.body):
            findings.append(_finding(
                mod.rel, entry.node, "KL008",
                f"CUDA entry {fn} has no plain PyTorch twin {plain} in "
                "its module: no CPU path and no oracle for the card"))
        if not re.search(rf"\b{fn}\b", tests):
            findings.append(_finding(
                mod.rel, entry.node, "KL008",
                f"CUDA entry {fn} has no case in tests/test_torch_cuda.py:"
                f" it is never held against {plain} on the card"))
    return findings


RULES = [
    Rule("KL006", "ctypes SIGNATURES match the extern \"C\" entry points",
         check_c_signatures),
    Rule("KL007", "CUDA launches validate inputs and check return codes",
         check_launches),
    Rule("KL008", "each *_cuda entry has a *_plain twin and a card test",
         check_two_oracles),
]
