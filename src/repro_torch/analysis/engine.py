"""Analysis engine: target discovery, parsing, and rule dispatch."""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

from .findings import SEVERITY_ERROR, Finding

# Directories scanned (relative to the repo root) when no explicit
# paths are given. tests/ is deliberately excluded: its fixture files
# are intentionally rule-violating.
_DEFAULT_SCAN_DIRS = ("src", "benchmarks")
_SKIP_DIR_NAMES = {"__pycache__", ".git", "tests", "fixtures"}


@dataclasses.dataclass
class Module:
    """One parsed Python source file."""

    path: Path
    rel: str                           # path relative to the scan root
    tree: ast.Module
    source: str

    @property
    def filename(self) -> str:
        return self.path.name


@dataclasses.dataclass
class AnalysisContext:
    """Everything a rule gets to see: parsed modules plus the budget
    file (the one non-Python artifact with an invariant of its own)."""

    root: Path
    modules: List[Module]
    budgets_path: Optional[Path]
    parse_failures: List[Finding]
    _callgraph: Optional[object] = dataclasses.field(default=None,
                                                     repr=False)

    def callgraph(self):
        if self._callgraph is None:
            from .callgraph import CallGraph
            self._callgraph = CallGraph.build(self.modules)
        return self._callgraph

    def modules_named(self, filename: str) -> List[Module]:
        return [m for m in self.modules if m.filename == filename]


def _find_repo_root() -> Path:
    """Repo root = nearest ancestor of this package holding
    src/repro_torch/."""
    here = Path(__file__).resolve()
    for parent in here.parents:
        if (parent / "src" / "repro_torch").is_dir() and parent.name != "src":
            return parent
    return Path.cwd()


def _iter_py_files(base: Path) -> Iterable[Path]:
    for path in sorted(base.rglob("*.py")):
        if any(part in _SKIP_DIR_NAMES for part in path.parts):
            continue
        yield path


def load_context(paths: Sequence[str] = ()) -> AnalysisContext:
    """Build the analysis context.

    No paths: scan the repo's ``src/`` and ``benchmarks/`` trees. A
    directory path: treat it as a miniature root (its ``*.py`` files
    plus an optional ``budgets.json``) -- this is how the fixture-based
    self-tests exercise the budget rule. A file path: analyze just it.
    """
    if paths:
        files: List[Path] = []
        budgets: Optional[Path] = None
        roots: List[Path] = []
        for raw in paths:
            p = Path(raw).resolve()
            if p.is_dir():
                roots.append(p)
                files.extend(p.rglob("*.py"))
                cand = p / "budgets.json"
                if cand.is_file():
                    budgets = cand
            elif p.suffix == ".json":
                budgets = p
                roots.append(p.parent)
            else:
                files.append(p)
                roots.append(p.parent)
        root = roots[0] if roots else Path.cwd()
        files = sorted(set(files))
    else:
        root = _find_repo_root()
        files = []
        for sub in _DEFAULT_SCAN_DIRS:
            base = root / sub
            if base.is_dir():
                files.extend(_iter_py_files(base))
        budgets = root / "benchmarks" / "budgets.json"
        if not budgets.is_file():
            budgets = None

    modules: List[Module] = []
    failures: List[Finding] = []
    for path in files:
        rel = _rel_to(path, root)
        try:
            source = path.read_text()
            tree = ast.parse(source, filename=str(path))
        except (SyntaxError, OSError) as exc:
            line = getattr(exc, "lineno", 1) or 1
            failures.append(Finding(
                file=rel, line=line, col=0, rule="PARSE",
                severity=SEVERITY_ERROR,
                message=f"could not parse module: {exc}"))
            continue
        modules.append(Module(path=path, rel=rel, tree=tree, source=source))
    return AnalysisContext(root=root, modules=modules,
                           budgets_path=budgets, parse_failures=failures)


def _rel_to(path: Path, root: Path) -> str:
    try:
        return path.relative_to(root).as_posix()
    except ValueError:
        return path.as_posix()


def run_analysis(ctx: AnalysisContext,
                 select: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run (selected) rules over the context; findings sorted by
    location for stable output."""
    from .rules import ALL_RULES
    findings: List[Finding] = list(ctx.parse_failures)
    for rule in ALL_RULES:
        if select and rule.rule_id not in select:
            continue
        findings.extend(rule.check(ctx))
    return sorted(findings)
