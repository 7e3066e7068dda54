"""Finding record emitted by analysis rules."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One analyzer diagnostic, anchored to a source location.

    Ordering is (file, line, col, rule) so reports are stable across
    runs regardless of rule execution order.
    """

    file: str
    line: int
    col: int
    rule: str
    severity: str
    message: str

    def format(self) -> str:
        return (f"{self.file}:{self.line}:{self.col}: "
                f"{self.severity} {self.rule} {self.message}")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "file": self.file,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }
