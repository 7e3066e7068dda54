"""repro-lint for the PyTorch port: the JAX package's static analyzer,
copied, with launch rules for the port's hand-written CUDA kernels.

The brTPF evaluation rests on measured request/transfer counts, so the
invariants that keep those counts honest are machine-checked:
byte-identical selector backends, coherent cache invalidation through
the unified ``FragmentStore``, honest ``Counters`` accounting for every
launch disposition, and launch-budget gates keyed by metric names. A
new code path that silently violates one of them fails this analyzer
before any parity test covers it.

Rule groups, over ``ast`` walks plus a lightweight intra-package call
graph (each rule module's docstring states the invariant it protects):

* **kernel-launch safety** (KL001-KL005, ``rules/kernel_launch.py``):
  static block shapes, power-of-two capacities and no traced scalar
  captures at ``pl.pallas_call`` sites, and segment counts recorded at
  every fused bind-join launch (``bindjoin_fused`` or the port's
  ``bindjoin_fused_cuda``);
* **CUDA launches** (KL006-KL008, ``rules/cuda_launch.py``): the
  port's ctypes signatures match the ``extern "C"`` entry points of
  ``csrc/*.cu``, each ``lib.brtpf_*`` launch validates its tensor
  inputs and checks its return code, and each ``*_cuda`` entry has its
  ``*_plain`` twin and a case in ``tests/test_torch_cuda.py``;
* **cache coherence** (CC...): mutations of ``TripleStore``/pattern
  data must reach a ``FragmentStore`` invalidation in the call graph,
  and nothing outside ``fragments.py`` touches the store's internals;
* **accounting integrity** (AC...): every ``LaunchRecord`` lands on a
  ``launches`` accounting surface, every disposition path increments
  exactly one launch counter, and every ``benchmarks/budgets.json`` key
  resolves to a metric ``core/metrics.py`` emits;
* **async safety** (AS...): no blocking calls inside ``async def``
  bodies;
* **dead code** (DC...) and **resilience** (RS...).

Every rule the JAX package has (``repro/analysis``) is here with the
same id, logic and message, word for word, so the two analyzers give
identical findings on the same inputs; only this package's root lookup
(``src/repro_torch``), its CLI name and KL005's extra call name differ.
The analyzer runs on the host and imports neither JAX nor the JAX
package.

Run it: ``python -m repro_torch.analysis`` (text) or ``--format json``
(machine-readable), ``--select KL006,KL007`` for some rules; it scans
the repo's ``src/`` and ``benchmarks/`` trees and exits nonzero on any
error-severity finding.
"""
from .engine import AnalysisContext, Module, load_context, run_analysis
from .findings import SEVERITY_ERROR, SEVERITY_WARNING, Finding
from .rules import ALL_RULES, Rule
from .rules.cuda_launch import CudaEntry, cuda_entries

__all__ = [
    "ALL_RULES",
    "AnalysisContext",
    "CudaEntry",
    "Finding",
    "Module",
    "Rule",
    "SEVERITY_ERROR",
    "SEVERITY_WARNING",
    "cuda_entries",
    "load_context",
    "run_analysis",
]
