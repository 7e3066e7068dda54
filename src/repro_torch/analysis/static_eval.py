"""Static-expression resolution for the kernel-launch rules.

Decides whether an expression inside a jitted kernel wrapper is
*static* -- known at trace time -- or potentially a traced value. The
judgment is deliberately conservative and syntactic: a name is static
if it is a module-level constant, a parameter listed in the enclosing
function's ``static_argnames``, or a local assigned from an expression
that is itself static. Array ``.shape`` accesses are static (shapes are
part of the abstract value), as are arithmetic/len/min/max over static
operands. Anything else -- in particular a bare parameter of a jitted
function that is *not* in ``static_argnames`` -- is treated as traced.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

_STATIC_BUILTINS = {"len", "max", "min", "int", "abs", "sum", "bool"}

# Attribute names whose access on *any* object yields a static value:
# array shapes (and derived rank/size) are trace-time constants.
_STATIC_ATTRS = {"shape", "ndim", "size", "dtype"}


def module_constants(tree: ast.Module) -> Set[str]:
    """Names bound at module level to literal constants."""
    consts: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Constant):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    consts.add(tgt.id)
        elif (isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)
              and isinstance(node.value, ast.Constant)):
            consts.add(node.target.id)
    return consts


def _str_elements(node: ast.expr) -> List[str]:
    """Extract string elements from a Constant/Tuple/List literal."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.append(elt.value)
        return out
    return []


def jit_static_argnames(func: ast.AST) -> Optional[Set[str]]:
    """``static_argnames`` of the enclosing ``jax.jit`` decorator.

    Returns None when the function is not jitted (host-level code whose
    parameters are concrete Python values, hence static), and the
    possibly-empty set of static parameter names when it is.
    """
    if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    for dec in func.decorator_list:
        names = _jit_names_from_decorator(dec)
        if names is not None:
            return names
    return None


def _dotted(node: ast.expr) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _jit_names_from_decorator(dec: ast.expr) -> Optional[Set[str]]:
    # @jax.jit / @jit -- jitted, no static argnames.
    if _dotted(dec) in ("jax.jit", "jit"):
        return set()
    if not isinstance(dec, ast.Call):
        return None
    callee = _dotted(dec.func)
    # @functools.partial(jax.jit, static_argnames=(...)) and
    # @jax.jit(static_argnames=(...)) both carry the kwarg directly.
    is_partial_jit = (callee in ("functools.partial", "partial")
                      and dec.args
                      and _dotted(dec.args[0]) in ("jax.jit", "jit"))
    is_jit_call = callee in ("jax.jit", "jit")
    if not (is_partial_jit or is_jit_call):
        return None
    names: Set[str] = set()
    for kw in dec.keywords:
        if kw.arg in ("static_argnames", "static_argnums") and kw.value:
            names.update(_str_elements(kw.value))
    return names


def static_env(func: ast.AST, consts: Set[str]) -> Set[str]:
    """Names statically resolvable inside ``func``'s body.

    Seeds: module constants plus static parameters. Locals assigned
    from static expressions join the set; two passes reach the fixed
    point for the straight-line assignment chains the kernels use.
    """
    env = set(consts)
    static_params = jit_static_argnames(func)
    if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
        args = func.args
        all_params = [a.arg for a in (args.posonlyargs + args.args
                                      + args.kwonlyargs)]
        if static_params is None:
            env.update(all_params)      # not jitted: concrete host values
        else:
            env.update(p for p in all_params if p in static_params)
        body = func.body
    else:
        body = getattr(func, "body", [])

    for _ in range(2):
        for stmt in ast.walk(ast.Module(body=list(body), type_ignores=[])):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                tgt = stmt.targets[0]
                if isinstance(tgt, ast.Name) and is_static(stmt.value, env):
                    env.add(tgt.id)
            elif (isinstance(stmt, ast.AnnAssign)
                  and isinstance(stmt.target, ast.Name)
                  and stmt.value is not None
                  and is_static(stmt.value, env)):
                env.add(stmt.target.id)
    return env


def is_static(node: ast.expr, env: Set[str]) -> bool:
    return not nonstatic_parts(node, env)


def nonstatic_parts(node: ast.expr, env: Set[str]) -> List[ast.expr]:
    """Sub-expressions of ``node`` that defeat static resolution.

    Returns the offending leaves (for precise findings); empty means
    the whole expression is static.
    """
    if isinstance(node, ast.Constant):
        return []
    if isinstance(node, ast.Name):
        return [] if node.id in env else [node]
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[ast.expr] = []
        for elt in node.elts:
            out.extend(nonstatic_parts(elt, env))
        return out
    if isinstance(node, ast.Attribute):
        # x.shape is static for traced x; other attribute chains are
        # host-object reads (module constants, self.<config>), which
        # are concrete at trace time.
        return []
    if isinstance(node, ast.Subscript):
        # x.shape[0] and tuple[i] indexing over static parts.
        sub = nonstatic_parts(node.slice, env)
        if isinstance(node.value, ast.Attribute):
            if node.value.attr in _STATIC_ATTRS:
                return sub
            return sub + [node]
        return sub + nonstatic_parts(node.value, env)
    if isinstance(node, ast.BinOp):
        return (nonstatic_parts(node.left, env)
                + nonstatic_parts(node.right, env))
    if isinstance(node, ast.UnaryOp):
        return nonstatic_parts(node.operand, env)
    if isinstance(node, ast.BoolOp):
        out = []
        for v in node.values:
            out.extend(nonstatic_parts(v, env))
        return out
    if isinstance(node, ast.Compare):
        out = nonstatic_parts(node.left, env)
        for c in node.comparators:
            out.extend(nonstatic_parts(c, env))
        return out
    if isinstance(node, ast.IfExp):
        return (nonstatic_parts(node.test, env)
                + nonstatic_parts(node.body, env)
                + nonstatic_parts(node.orelse, env))
    if isinstance(node, ast.Call):
        if (isinstance(node.func, ast.Name)
                and node.func.id in _STATIC_BUILTINS):
            out = []
            for a in node.args:
                out.extend(nonstatic_parts(a, env))
            for kw in node.keywords:
                if kw.value is not None:
                    out.extend(nonstatic_parts(kw.value, env))
            return out
        return [node]
    return [node]
