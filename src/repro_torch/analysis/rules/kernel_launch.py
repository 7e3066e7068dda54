"""Kernel-launch safety rules (KL...).

The Pallas kernels are only correct under launch
conventions the call sites must uphold by hand: explicit launch
geometry on every ``pl.pallas_call``, block shapes that are static at
trace time (a traced Python scalar in a BlockSpec either fails deep in
Mosaic or silently retraces per shape), and power-of-two tile/window
capacities (lane alignment on TPU; the sharded window math in
docs/sharding.md additionally assumes window | range arithmetic that
only holds for powers of two).

The rules are the JAX package's, kept verbatim so both analyzers agree
finding for finding. The port's own tree launches no Pallas kernel: its
kernels are CUDA C++ called through ctypes, so KL001-KL003 find no site
there, and ``rules/cuda_launch.py`` (KL006-KL008) guards those launches
in their place. KL004 and KL005 apply to both packages; KL005 also
matches the port's ``bindjoin_fused_cuda``.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from ..engine import AnalysisContext, Module
from ..findings import SEVERITY_ERROR, Finding
from ..static_eval import module_constants, nonstatic_parts, static_env
from . import Rule

REQUIRED_KWARGS = ("grid", "in_specs", "out_specs", "out_shape",
                   "interpret")

# Capacity-constant name tokens that must be powers of two. SLOTS /
# STREAM / SEGMENTS are the fused-launch table capacities (docs/
# fusion.md): the fused stream is tiled and padded to pow2 tile counts,
# and the slot/segment tables are sized from these caps, so a non-pow2
# cap silently breaks the padding arithmetic.
_POW2_TOKENS = {"BT", "BM", "BR", "LANES", "WINDOW", "BUCKET",
                "SLOTS", "STREAM", "SEGMENTS"}


def _dotted_tail(node: ast.expr) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _pallas_call_sites(mod: Module) -> List[Tuple[Optional[ast.AST],
                                                  ast.Call]]:
    """(enclosing function, call) for each ``pl.pallas_call`` site."""
    sites: List[Tuple[Optional[ast.AST], ast.Call]] = []

    def visit(node: ast.AST, func: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            enclosing = func
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                enclosing = child
            if (isinstance(child, ast.Call)
                    and _dotted_tail(child.func) == "pallas_call"):
                sites.append((func, child))
            visit(child, enclosing)

    visit(mod.tree, None)
    return sites


def check_pallas_kwargs(ctx: AnalysisContext) -> List[Finding]:
    """KL001: every pallas_call declares the full launch geometry.

    Keyed on ``pl.pallas_call``, which the port's tree never calls; its
    counterpart there is KL006 (the ctypes signature of each C entry
    point matches its ``extern "C"`` definition)."""
    findings: List[Finding] = []
    for mod in ctx.modules:
        for _, call in _pallas_call_sites(mod):
            present = {kw.arg for kw in call.keywords if kw.arg}
            missing = [k for k in REQUIRED_KWARGS if k not in present]
            if missing:
                findings.append(Finding(
                    file=mod.rel, line=call.lineno, col=call.col_offset,
                    rule="KL001", severity=SEVERITY_ERROR,
                    message=("pl.pallas_call missing required launch "
                             f"kwargs: {', '.join(missing)}")))
    return findings


def _block_shape_arg(call: ast.Call) -> Optional[ast.expr]:
    """The block-shape expression of a ``pl.BlockSpec(...)`` call."""
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "block_shape":
            return kw.value
    return None


def check_static_block_shapes(ctx: AnalysisContext) -> List[Finding]:
    """KL002: BlockSpec block shapes and ShapeDtypeStruct dims resolve
    statically inside the enclosing (jitted) wrapper.

    No site in the port's tree; its counterpart there is KL007 (every
    tensor a ``lib.brtpf_*`` launch reads is validated by a ``_check*``
    helper first, and the launch's return code is checked)."""
    findings: List[Finding] = []
    for mod in ctx.modules:
        consts = module_constants(mod.tree)
        for func, call in _pallas_call_sites(mod):
            env = static_env(func, consts) if func is not None else consts
            for inner in ast.walk(call):
                if not isinstance(inner, ast.Call):
                    continue
                tail = _dotted_tail(inner.func)
                if tail == "BlockSpec":
                    shape = _block_shape_arg(inner)
                    if shape is None:
                        continue
                    bad = nonstatic_parts(shape, env)
                    if bad:
                        names = ", ".join(
                            ast.unparse(b) for b in bad[:3])
                        findings.append(Finding(
                            file=mod.rel, line=inner.lineno,
                            col=inner.col_offset, rule="KL002",
                            severity=SEVERITY_ERROR,
                            message=("BlockSpec block shape is not "
                                     "static at trace time "
                                     f"(non-static: {names}); mark the "
                                     "parameter static_argnames or "
                                     "derive it from a module constant "
                                     "/ input shape")))
                elif tail == "ShapeDtypeStruct" and inner.args:
                    bad = nonstatic_parts(inner.args[0], env)
                    if bad:
                        names = ", ".join(
                            ast.unparse(b) for b in bad[:3])
                        findings.append(Finding(
                            file=mod.rel, line=inner.lineno,
                            col=inner.col_offset, rule="KL002",
                            severity=SEVERITY_ERROR,
                            message=("out_shape dims are not static at "
                                     f"trace time (non-static: {names})")))
    return findings


def check_traced_grid(ctx: AnalysisContext) -> List[Finding]:
    """KL003: the launch grid must not capture traced Python scalars.

    No site in the port's tree: a CUDA launch computes its grid in C
    from host integers. Its counterparts there are KL007 and KL008
    (each ``*_cuda`` entry has a ``*_plain`` twin and a case in
    ``tests/test_torch_cuda.py``)."""
    findings: List[Finding] = []
    for mod in ctx.modules:
        consts = module_constants(mod.tree)
        for func, call in _pallas_call_sites(mod):
            env = static_env(func, consts) if func is not None else consts
            for kw in call.keywords:
                if kw.arg != "grid" or kw.value is None:
                    continue
                bad = nonstatic_parts(kw.value, env)
                if bad:
                    names = ", ".join(ast.unparse(b) for b in bad[:3])
                    findings.append(Finding(
                        file=mod.rel, line=kw.value.lineno,
                        col=kw.value.col_offset, rule="KL003",
                        severity=SEVERITY_ERROR,
                        message=("pallas_call grid captures traced "
                                 f"value(s): {names}; grids must be "
                                 "Python ints at trace time")))
    return findings


def check_pow2_capacities(ctx: AnalysisContext) -> List[Finding]:
    """KL004: capacity constants (tile sizes, shard windows, range
    buckets) are powers of two."""
    findings: List[Finding] = []
    for mod in ctx.modules:
        for node in mod.tree.body:
            pairs: List[Tuple[ast.Name, ast.expr]] = []
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                if isinstance(node.targets[0], ast.Name):
                    pairs.append((node.targets[0], node.value))
            elif (isinstance(node, ast.AnnAssign)
                  and isinstance(node.target, ast.Name)
                  and node.value is not None):
                pairs.append((node.target, node.value))
            for name, value in pairs:
                if name.id != name.id.upper():
                    continue
                tokens = set(name.id.split("_"))
                if not tokens & _POW2_TOKENS:
                    continue
                if not (isinstance(value, ast.Constant)
                        and isinstance(value.value, int)
                        and not isinstance(value.value, bool)):
                    continue
                v = value.value
                if v <= 0 or v & (v - 1):
                    findings.append(Finding(
                        file=mod.rel, line=node.lineno,
                        col=node.col_offset, rule="KL004",
                        severity=SEVERITY_ERROR,
                        message=(f"capacity constant {name.id} = {v} is "
                                 "not a power of two; tile/window/bucket "
                                 "sizes must be lane- and "
                                 "window-aligned")))
    return findings


def _records_segments(mod: Module) -> bool:
    """Does this module append a ``LaunchRecord(...)`` carrying a
    ``segments=`` kwarg to a ``launches`` sink anywhere?"""
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append"
                and _dotted_tail(node.func.value) == "launches"):
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if (isinstance(arg, ast.Call)
                    and _dotted_tail(arg.func) == "LaunchRecord"
                    and any(kw.arg == "segments" for kw in arg.keywords)):
                return True
    return False


def _delegations(mod: Module) -> Set[int]:
    """ids of the ``bindjoin_fused_cuda`` calls inside functions named
    ``bindjoin_fused``: the op delegating to its kernel, whose own call
    sites stand for them."""
    return {id(node) for func in ast.walk(mod.tree)
            if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef))
            and func.name == "bindjoin_fused"
            for node in ast.walk(func) if isinstance(node, ast.Call)}


def check_fused_launch_accounting(ctx: AnalysisContext) -> List[Finding]:
    """KL005: every module that launches the fused bind-join records
    its segment count into a LaunchRecord sink.

    ``fused_segments_per_launch`` (the headline metric of docs/
    fusion.md) and the simulator's fused cost model both read segment
    counts off ``LaunchRecord.segments`` -- a fused call site that does
    not append ``launches.append(LaunchRecord(..., segments=...))``
    silently drops its launches from that accounting. The match is on
    the exact call name ``bindjoin_fused`` (the marshaling op), not its
    ``*_pallas`` / ``*_ref`` internals, which are below the accounting
    boundary -- and on ``bindjoin_fused_cuda``, the port's kernel
    wrapper, which the port's selectors call directly. A
    ``bindjoin_fused_cuda`` call inside a function named
    ``bindjoin_fused`` is that op delegating to its kernel; the op's
    own call sites are the ones matched.
    """
    findings: List[Finding] = []
    for mod in ctx.modules:
        inner = _delegations(mod)
        calls = [node for node in ast.walk(mod.tree)
                 if isinstance(node, ast.Call)
                 and (_dotted_tail(node.func) == "bindjoin_fused"
                      or (_dotted_tail(node.func) == "bindjoin_fused_cuda"
                          and id(node) not in inner))]
        if not calls or _records_segments(mod):
            continue
        call = calls[0]
        findings.append(Finding(
            file=mod.rel, line=call.lineno, col=call.col_offset,
            rule="KL005", severity=SEVERITY_ERROR,
            message=(f"module calls {_dotted_tail(call.func)} but "
                     "never records a segment count -- add launches.append("
                     "LaunchRecord(..., segments=...)) so fused "
                     "launches stay visible to "
                     "fused_segments_per_launch accounting")))
    return findings


RULES = [
    Rule("KL001", "pallas_call declares full launch geometry",
         check_pallas_kwargs),
    Rule("KL002", "BlockSpec/out_shape dims are static at trace time",
         check_static_block_shapes),
    Rule("KL003", "launch grid captures no traced scalars",
         check_traced_grid),
    Rule("KL004", "capacity constants are powers of two",
         check_pow2_capacities),
    Rule("KL005", "fused launches record segment counts",
         check_fused_launch_accounting),
]
