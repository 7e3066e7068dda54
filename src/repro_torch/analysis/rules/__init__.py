"""Rule registry. Each rule module exports ``RULES: List[Rule]``."""
from __future__ import annotations

import dataclasses
from typing import Callable, List

from ..engine import AnalysisContext
from ..findings import Finding


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    summary: str
    check: Callable[[AnalysisContext], List[Finding]]


def _collect() -> List[Rule]:
    from . import (accounting, async_safety, cache_coherence, cuda_launch,
                   dead_code, kernel_launch, resilience)
    rules: List[Rule] = []
    for mod in (kernel_launch, cuda_launch, cache_coherence, accounting,
                async_safety, dead_code, resilience):
        rules.extend(mod.RULES)
    return rules


ALL_RULES: List[Rule] = _collect()

__all__ = ["ALL_RULES", "Rule"]
