"""Request/transfer accounting -- the paper's evaluation metrics.

* ``num_requests`` (#req): fragment *pages* requested (section 5.1 --
  "the measurements for #req ... correspond ... to the number of pages
  requested").
* ``data_received`` (dataRecv): RDF triples contained in all fragment
  pages received, data + metadata/control triples (section 5.1).
* ``cache_hits`` (#hits): requests served by the HTTP cache (section 7.1).
* ``launches_skipped``: requests served from the unified fragment store
  (``core/fragments.py``) that would otherwise have reached an
  accelerated selector -- kernel/window launches avoided by residency.
* server/client work counters feed the throughput simulation (section 6).

:func:`metrics_snapshot` is the ONE observability schema (brtpf/v1):
counters plus the per-layer surface over the unified store -- the HTTP
cache's section-7 hit rate, the selector-memo (data-layer) hit rate,
the candidate-range memo hit rate and the skipped-launch count -- each
layer accounted separately, so memo traffic can never masquerade as
HTTP hits. ``BrTPFServer.metrics_snapshot()``, the async front end's
``AsyncBrTPFServer.metrics_snapshot()``, the replica router's merged
snapshot and the ASGI app's ``GET /metrics`` all emit THIS schema, the
same one the JAX package emits.

:func:`latency_summary` is the shared latency-quantile schema of the
app's per-route section and of the chaos run's outcome
(:func:`chaos_summary`): p50/p95/p99 latency in milliseconds plus
``req_per_s``.

:data:`TRACE` is the serving path's span recorder (``core/trace.py``):
one id per request, the host phases of each flush, recorded only while
a ``torch.profiler`` session is on (docs/torch_tracing.md).

:data:`STORE_BUILD` records, always, the seconds of the newest store
build by phase and its key layout's field widths.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

from .trace import TRACE, Span, SpanRing  # noqa: F401


@dataclasses.dataclass
class Counters:
    num_requests: int = 0
    data_received: int = 0          # triples (data + metadata)
    data_triples: int = 0           # data triples only
    meta_triples: int = 0
    cache_hits: int = 0
    server_lookups: int = 0         # index lookups performed by the server
    server_triples_scanned: int = 0
    mappings_sent: int = 0          # solution mappings attached to requests
    # kernel-selector launch accounting (selector_backend="kernel"):
    kernel_launches: int = 0        # grouped bind-join kernel launches
    kernel_cand_streamed: int = 0   # padded candidates streamed (HBM pass)
    kernel_cand_rows: int = 0       # raw (pre-padding) candidate rows
    kernel_cand_full_rows: int = 0  # raw full-range rows behind launches
    kernel_pat_slots: int = 0       # padded pattern slots across groups
    kernel_batched_requests: int = 0  # requests served by shared launches
    launches_skipped: int = 0       # launches avoided by store residency
    # Omega-restricted pruning / small-work fast path (docs/pruning.md):
    cand_pruned_away: int = 0       # candidate rows NOT streamed thanks
    #                                 to sub-range pruning (full - pruned)
    fast_path_selects: int = 0      # requests served by the numpy block
    #                                 evaluation instead of a launch
    # Cross-pattern kernel fusion (docs/fusion.md). These classify a
    # subset of kernel_launches (a fused launch IS a kernel launch);
    # they are descriptive shape counters, not request dispositions.
    fused_launches: int = 0         # launches serving >= 2 segments
    fused_segments: int = 0         # segments across fused launches

    def merge(self, other: "Counters") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))

    def snapshot(self) -> "Counters":
        return dataclasses.replace(self)

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


@dataclasses.dataclass
class CudaWork:
    """The work an accelerated selector gave the CUDA bind-join kernels,
    beside :class:`Counters` (whose fields stay the JAX package's).

    ``launches`` counts kernel launches: one per grouped or fused launch
    of the kernel backend, one per grouped or fused chunk of window pages
    of the sharded backend (where ``Counters.kernel_launches`` counts a
    LaunchRecord per page). ``live_slots`` sums, over the LaunchRecords
    charged, the pattern slots the kernel's loop visits per streamed row:
    each group's slots up to its last valid one (``pat_slots`` sums the
    padded ones); a fused record counts its widest segment's, as
    ``pat_slots`` counts one segment's grid. The throughput simulator
    charges these (``sim.kernel_charge``). ``rows_back`` counts the kept
    rows the launches' compactions copied back to the host (the
    ``collect`` phase), on both backends."""

    launches: int = 0
    live_slots: int = 0
    # kept rows the launches' results brought back from the device
    rows_back: int = 0

    def snapshot(self) -> "CudaWork":
        return dataclasses.replace(self)


class PhaseClock:
    """Charges the seconds since its previous mark (or its start) to the
    name of each mark, in ``phases``."""

    def __init__(self, phases: Dict[str, float]) -> None:
        self.phases = phases
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        t = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + t - self._t
        self._t = t


@dataclasses.dataclass
class StoreBuild:
    """The newest store build, by phase, in seconds.

    ``host``: the ``TripleStore`` (``dedup``: the SPO keys, their sort
    and the distinct rows; ``pos``, ``osp``: each order's keys and
    sort). ``device``: the ``FederatedStore`` built over it (``spo``,
    ``pos``, ``osp``: each order's keys and per-shard sort; ``copy``:
    the shard indexes' copies to the device). ``widths``: the store's
    key layout, each order's field widths, highest field first."""

    host: Dict[str, float] = dataclasses.field(default_factory=dict)
    device: Dict[str, float] = dataclasses.field(default_factory=dict)
    widths: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)

    def phases(self, part: str) -> PhaseClock:
        """A clock recording ``part`` (``"host"`` or ``"device"``) anew;
        a host build starts a new record."""
        if part == "host":
            self.device, self.widths = {}, {}
        phases: Dict[str, float] = {}
        setattr(self, part, phases)
        return PhaseClock(phases)


STORE_BUILD = StoreBuild()


METRICS_VERSION = "brtpf/v1"


def metrics_snapshot(server, batch=None) -> dict:
    """Canonical per-server metrics envelope (brtpf/v1 schema).

    Duck-typed on the server (``fragments``, ``store``, optional
    ``cache``) so this module stays import-light. Each layer reports
    its own hits/misses/hit_rate; ``launches_skipped`` is the unified
    store's count of kernel/window launches avoided by residency.
    ``batch`` optionally attaches an async front end's
    :class:`~repro_torch.core.batching.BatchStats` under ``"batch"`` (the
    flush/coalescing accounting the wire exposes at ``GET /metrics``).

    Every value is a plain int/float/dict: the snapshot is JSON-safe by
    construction, so the in-process dict and the ``GET /metrics`` body
    are the same object modulo serialization.
    """
    f = server.fragments
    # Range-memo accounting is reported as THIS server's delta (the
    # store, and its counters, may be shared across servers -- e.g. the
    # benchmarks' one dataset store); probe paths additionally never
    # charge misses (store.candidate_range(memoize=False)), so the rate
    # below describes real streaming reads only.
    base_hits, base_misses = getattr(server, "_range_base", (0, 0))
    r_hits = server.store.range_memo_hits - base_hits
    r_misses = server.store.range_memo_misses - base_misses
    out = {
        "v": METRICS_VERSION,
        "counters": dataclasses.asdict(server.counters),
        "launches_skipped": f.launches_skipped,
        "selector_memo": {
            "hits": f.hits,
            "misses": f.misses,
            "hit_rate": f.hit_rate,
            "entries": f.data_entries,
        },
        "range_memo": {
            "hits": r_hits,
            "misses": r_misses,
            "hit_rate": r_hits / max(r_hits + r_misses, 1),
        },
        # mean segments per fused launch (1.0-equivalent batches never
        # fuse, so 0.0 means "no fusion happened"): the headline shape
        # metric of docs/fusion.md, derived here so every surface (wire
        # and in-process) computes it identically.
        "fused_segments_per_launch": (
            server.counters.fused_segments
            / max(server.counters.fused_launches, 1)),
    }
    if server.cache is not None:
        out["http"] = {
            "hits": server.cache.hits,
            "misses": server.cache.misses,
            "hit_rate": server.cache.hit_rate,
            "entries": len(server.cache),
        }
    sel = getattr(server, "_selector", None)
    if sel is not None and hasattr(sel, "shard_balance"):
        # per-shard balance (sharded backend): the heat source AND its
        # verification surface (docs/federation.md, "Placement")
        out["shards"] = sel.shard_balance()
    if batch is not None:
        out["batch"] = {
            "requests": batch.requests,
            "rejected": batch.rejected,
            "fast_path": batch.fast_path,
            "flushes": batch.flushes,
            "timer_flushes": batch.timer_flushes,
            "full_flushes": batch.full_flushes,
            "coalesced_requests": batch.coalesced_requests,
            "max_batch_seen": batch.max_batch_seen,
            "mean_batch": batch.mean_batch,
            "shed": batch.shed,
        }
        out["resilience"] = resilience_section(shed=batch.shed)
    return out


def resilience_section(retries: int = 0, hedges: int = 0,
                       hedge_wins: int = 0, shed: int = 0,
                       deadline_exceeded: int = 0, giveups: int = 0,
                       breaker: Optional[dict] = None) -> dict:
    """The ``"resilience"`` section of :func:`metrics_snapshot`
    (docs/resilience.md) -- one schema for every surface that reports
    fault-tolerance accounting:

    * a lone async front end reports only ``shed`` (its deadline-aware
      shedding is the one resilience mechanism that lives server-side);
    * the replica router adds the summed replica ``shed`` plus its
      ``breaker`` sub-section (state machine transitions/opens/failovers
      per docs/resilience.md);
    * a :class:`~repro_torch.serving.resilience.ResilientTransport`
      overlays its client-side ``retries`` / ``hedges`` / ``hedge_wins``
      / ``deadline_exceeded`` / ``giveups`` when asked for metrics, so
      ``GET /metrics`` through a resilient client shows the whole
      retry/hedge/shed story in one envelope.
    """
    out = {
        "retries": int(retries),
        "hedges": int(hedges),
        "hedge_wins": int(hedge_wins),
        "shed": int(shed),
        "deadline_exceeded": int(deadline_exceeded),
        "giveups": int(giveups),
    }
    if breaker is not None:
        out["breaker"] = breaker
    return out


def chaos_summary(ok: int, failed: int, failed_queries: int,
                  samples_s: Sequence[float],
                  wall_s: Optional[float] = None,
                  parity: float = 1.0) -> dict:
    """Outcome schema of a chaos run (the JAX package's
    ``benchmarks/chaos.py`` and ``chip_smoke.py``'s edge phase).

    ``ok``/``failed`` count client-visible request outcomes AFTER the
    resilience layer did its work (a request that succeeded on retry 3
    is one ``ok``); ``failed_queries`` counts whole BGP executions
    abandoned because one of their requests exhausted every attempt;
    ``parity`` is 1.0 iff every query that completed under faults
    produced byte-identical solutions to the fault-free oracle.
    Latency quantiles ride along via :func:`latency_summary` so the same
    run reports both availability and tail latency.
    """
    total = ok + failed
    out = {
        "ok": int(ok),
        "failed": int(failed),
        "failed_queries": int(failed_queries),
        "success_rate": ok / total if total else 0.0,
        "parity": float(parity),
    }
    out.update(latency_summary(samples_s, wall_s))
    return out


def shard_balance(launches: Sequence[int], rows: Sequence[int],
                  pages: Sequence[int]) -> dict:
    """Per-shard balance schema (the ``shards`` section of
    :func:`metrics_snapshot`, docs/federation.md "Placement").

    ``launches``/``rows``/``pages`` are the selector's per-shard
    attribution counters: launches the shard had work in, candidate rows
    it streamed, planned window pages it owned. ``imbalance`` is
    max/mean launches per shard -- 1.0 is perfectly balanced, ``shards``x
    is everything on one shard; the quantity the workload-aware
    re-partitioner minimizes and the ``skew_c16:*`` budgets gate.
    """
    launches = [int(x) for x in launches]
    rows = [int(x) for x in rows]
    pages = [int(x) for x in pages]
    mean = sum(launches) / max(len(launches), 1)
    return {
        "launches": launches,
        "rows": rows,
        "pages": pages,
        "imbalance": (max(launches) / mean) if mean > 0 else 0.0,
    }


def rebalance_report(uniform: dict, heat: dict) -> dict:
    """Before/after schema for a repartition A/B (the skew benchmark's
    budget surface): :func:`shard_balance` snapshots measured under the
    workload-blind equal split (``uniform``) and under the heat-planned
    placement (``heat``). ``imbalance_drop`` > 1 means the re-partition
    helped; the ``skew_c16:imbalance_drop`` budget gates it >= 2.
    """
    drop = uniform["imbalance"] / max(heat["imbalance"], 1e-9)
    return {
        "imbalance_uniform": uniform["imbalance"],
        "imbalance_heat": heat["imbalance"],
        "imbalance_drop": drop,
        "shard_launches_uniform": uniform["launches"],
        "shard_launches_heat": heat["launches"],
    }


def latency_summary(samples_s: Sequence[float],
                    wall_s: Optional[float] = None) -> dict:
    """Latency-quantile schema: per-request latencies (seconds) ->
    p50/p95/p99/mean milliseconds + closed-loop ``req_per_s``.

    Quantiles use the nearest-rank method on the sorted samples -- no
    numpy dependency, deterministic, and exact for the small sample
    counts a smoke run produces.
    """
    n = len(samples_s)
    if n == 0:
        return {"requests": 0, "p50_latency_ms": 0.0,
                "p95_latency_ms": 0.0, "p99_latency_ms": 0.0,
                "mean_latency_ms": 0.0, "req_per_s": 0.0}
    ordered = sorted(samples_s)

    def rank_ms(q: float) -> float:
        idx = min(n - 1, max(0, int(q * n + 0.5) - 1))
        return ordered[idx] * 1e3

    wall = wall_s if wall_s is not None else sum(ordered)
    return {
        "requests": n,
        "p50_latency_ms": rank_ms(0.50),
        "p95_latency_ms": rank_ms(0.95),
        "p99_latency_ms": rank_ms(0.99),
        "mean_latency_ms": sum(ordered) / n * 1e3,
        "req_per_s": n / max(wall, 1e-9),
    }
