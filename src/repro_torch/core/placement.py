"""Workload-aware placement: heat-based shard boundaries + hot-range
replication (docs/federation.md, "Placement").

The legacy ``FederatedStore.build`` splits each index order's sorted key
space into equal contiguous shards, so a hot predicate's entire prefix
range lands on one shard while the others idle.  This module derives a
:class:`Placement` from observed traffic instead:

* :class:`HeatLog` -- a bounded log of per-key-range heat records
  (launches, streamed candidate rows, planned window pages), fed by the
  selectors as they plan windows.  Bounded means it is a sliding window
  over recent traffic, which is what a re-partitioner should follow.
* :func:`weighted_boundaries` -- a weighted-quantile split over the
  packed int64 key space that equalizes *expected launches per shard*
  instead of byte counts, computed per index order because the POS/OSP
  mirrors have their own hot ranges.
* :func:`plan_placement` -- boundaries plus :class:`ReplicaRange`s: the
  hottest sub-range of any shard still hot after re-balancing is copied
  onto the coldest shard(s), so the routed launch path can serve it from
  the least-loaded owner.  Dedup is the router's job (exactly one owner
  streams a replicated range per launch); this module only decides who
  holds copies.

Everything here is host-side numpy, so placements can be planned from
traces offline as well as from a live server. This is the port's copy of
``repro.core.placement``; the port's sharded backend holds its shards as
logical shards on one device, and the plan is the same.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .store import _ORDERS, KeyLayout

__all__ = [
    "HeatRecord",
    "HeatLog",
    "ReplicaRange",
    "Placement",
    "dataset_keys",
    "equal_boundaries",
    "heat_weights",
    "weighted_boundaries",
    "plan_placement",
]


@dataclasses.dataclass(frozen=True)
class HeatRecord:
    """One observed launch burst over a key range of one index order.

    ``lo_key``/``hi_key`` are *inclusive* packed-key bounds of the
    planned candidate range (the selector's ``plan.lo_key``/``hi_key``).
    """

    order: str
    lo_key: int
    hi_key: int
    launches: int = 1
    rows: int = 0
    pages: int = 0


class HeatLog:
    """Bounded log of :class:`HeatRecord`s (oldest evicted first)."""

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._records: Deque[HeatRecord] = deque(maxlen=self.capacity)

    def record(
        self,
        order: str,
        lo_key: int,
        hi_key: int,
        launches: int = 1,
        rows: int = 0,
        pages: int = 0,
    ) -> None:
        self._records.append(
            HeatRecord(
                order=str(order),
                lo_key=int(lo_key),
                hi_key=int(hi_key),
                launches=int(launches),
                rows=int(rows),
                pages=int(pages),
            )
        )

    def records(self, order: Optional[str] = None) -> List[HeatRecord]:
        if order is None:
            return list(self._records)
        return [r for r in self._records if r.order == order]

    def merge(self, other: "HeatLog") -> None:
        for rec in other._records:
            self._records.append(rec)

    def clear(self) -> None:
        self._records.clear()

    def __len__(self) -> int:
        return len(self._records)

    @property
    def total_launches(self) -> int:
        return sum(r.launches for r in self._records)


@dataclasses.dataclass(frozen=True)
class ReplicaRange:
    """A replicated key sub-range: ``home`` owns the primary copy, every
    shard in ``replicas`` holds a byte-identical copy.  Bounds are
    inclusive packed keys."""

    order: str
    lo_key: int
    hi_key: int
    home: int
    replicas: Tuple[int, ...]

    @property
    def holders(self) -> Tuple[int, ...]:
        return (self.home,) + tuple(s for s in self.replicas if s != self.home)


@dataclasses.dataclass
class Placement:
    """Per-order shard boundaries + replicated hot ranges.

    ``boundaries[order]`` is a sorted int64 array of ``shards - 1`` cut
    keys; a key ``k`` lives on shard ``searchsorted(bounds, k, "right")``
    (cut keys start the shard to their right).  Orders without an entry
    fall back to an equal-count contiguous split at build time.
    """

    boundaries: Dict[str, np.ndarray]
    replicas: Dict[str, Tuple[ReplicaRange, ...]] = dataclasses.field(
        default_factory=dict
    )

    def shard_of(self, order: str, keys: np.ndarray) -> np.ndarray:
        bounds = np.asarray(self.boundaries[order], dtype=np.int64)
        return np.searchsorted(bounds, np.asarray(keys, dtype=np.int64), side="right")

    @property
    def has_replicas(self) -> bool:
        return any(self.replicas.values())


def dataset_keys(
    triples_np: np.ndarray, layout: Optional[KeyLayout] = None
) -> Dict[str, np.ndarray]:
    """Sorted packed keys per index order for a host triple array, under
    ``layout`` (the store's; None: the triples' own, ``KeyLayout.of``).
    :class:`Placement` boundaries and replica ranges are keys of the same
    layout."""
    triples_np = np.asarray(triples_np)
    if layout is None:
        layout = KeyLayout.of(triples_np)
    return {name: np.sort(layout.pack(triples_np, name)) for name in _ORDERS}


def equal_boundaries(keys_sorted: np.ndarray, shards: int) -> np.ndarray:
    """Equal-count contiguous cut keys (the workload-blind fallback)."""
    keys_sorted = np.asarray(keys_sorted, dtype=np.int64)
    if shards <= 1 or keys_sorted.size == 0:
        return np.empty((0,), dtype=np.int64)
    idx = np.arange(1, shards) * keys_sorted.size // shards
    idx = np.clip(idx, 0, keys_sorted.size - 1)
    return keys_sorted[idx].astype(np.int64)


def heat_weights(
    keys_sorted: np.ndarray,
    records: Iterable[HeatRecord],
    base: float = 1.0,
) -> np.ndarray:
    """Per-key expected-launch weights from heat records.

    Each record's launches are spread uniformly over the keys inside its
    ``[lo_key, hi_key]`` range (difference-array accumulation, so cost is
    O(records + keys)).  ``base`` gives every key a small uniform weight
    so cold ranges still split sanely when the log is sparse.
    """
    keys_sorted = np.asarray(keys_sorted, dtype=np.int64)
    w = np.full(keys_sorted.shape, float(base), dtype=np.float64)
    if keys_sorted.size == 0:
        return w
    diff = np.zeros(keys_sorted.size + 1, dtype=np.float64)
    for rec in records:
        i0 = int(np.searchsorted(keys_sorted, rec.lo_key, side="left"))
        i1 = int(np.searchsorted(keys_sorted, rec.hi_key, side="right"))
        if i1 <= i0:
            continue
        per_key = float(rec.launches) / (i1 - i0)
        diff[i0] += per_key
        diff[i1] -= per_key
    w += np.cumsum(diff[:-1])
    return w


def weighted_boundaries(
    keys_sorted: np.ndarray, weights: Sequence[float], shards: int
) -> np.ndarray:
    """Weighted-quantile cut keys equalizing per-shard weight mass.

    Returns ``shards - 1`` sorted cut keys under the same convention as
    :meth:`Placement.shard_of` (a cut key starts the shard to its right).
    """
    keys_sorted = np.asarray(keys_sorted, dtype=np.int64)
    if shards <= 1 or keys_sorted.size == 0:
        return np.empty((0,), dtype=np.int64)
    w = np.asarray(weights, dtype=np.float64)
    if w.shape != keys_sorted.shape:
        raise ValueError(f"weights shape {w.shape} != keys shape {keys_sorted.shape}")
    cum = np.cumsum(w)
    total = float(cum[-1])
    if total <= 0.0:
        return equal_boundaries(keys_sorted, shards)
    cuts = total * np.arange(1, shards, dtype=np.float64) / shards
    idx = np.searchsorted(cum, cuts, side="left")
    idx = np.clip(idx, 0, keys_sorted.size - 1)
    return keys_sorted[idx].astype(np.int64)


def _shard_spans(
    bounds: np.ndarray, shards: int
) -> List[Tuple[int, int]]:
    """Inclusive key span owned by each shard under ``bounds``."""
    lo = np.iinfo(np.int64).min
    hi = np.iinfo(np.int64).max
    edges = [lo] + [int(b) for b in bounds] + [hi + 0]
    spans = []
    for s in range(shards):
        s_lo = edges[s]
        s_hi = edges[s + 1] - 1 if s < shards - 1 else hi
        spans.append((s_lo, s_hi))
    return spans


def plan_placement(
    heat: HeatLog,
    keys_by_order: Dict[str, np.ndarray],
    shards: int,
    base_weight: float = 0.05,
    hot_factor: float = 1.25,
    max_replicas: int = 1,
) -> Placement:
    """Plan boundaries + replication from a heat log.

    Per order: weighted-quantile boundaries from :func:`heat_weights`;
    then, if the hottest shard still carries more than ``hot_factor``
    times the mean weight (an un-splittable hot range, e.g. all heat on
    a handful of keys), its hottest observed sub-range is replicated
    onto the ``max_replicas`` coldest shards so the routed launch path
    can serve it from the least-loaded owner.

    ``base_weight`` is the *fraction of the observed heat mass* spread
    uniformly over all keys (cold ranges still split sanely); it is
    normalized per order so a long log can never drown the signal the
    way an absolute per-key constant would on a large key space.
    """
    boundaries: Dict[str, np.ndarray] = {}
    replicas: Dict[str, Tuple[ReplicaRange, ...]] = {}
    for name in _ORDERS:
        keys = np.asarray(keys_by_order.get(name, np.empty(0)), dtype=np.int64)
        recs = heat.records(name)
        mass = float(sum(r.launches for r in recs))
        per_key_base = (base_weight * max(mass, 1.0) / max(keys.size, 1))
        w = heat_weights(keys, recs, base=per_key_base)
        bounds = weighted_boundaries(keys, w, shards)
        boundaries[name] = bounds
        if shards <= 1 or keys.size == 0 or not recs:
            continue
        assign = np.searchsorted(bounds, keys, side="right")
        shard_w = np.bincount(assign, weights=w, minlength=shards)[:shards]
        mean_w = float(shard_w.sum()) / shards
        if mean_w <= 0.0:
            continue
        hot = int(np.argmax(shard_w))
        if float(shard_w[hot]) <= hot_factor * mean_w:
            continue
        span_lo, span_hi = _shard_spans(bounds, shards)[hot]
        best = None
        for rec in recs:
            lo = max(rec.lo_key, span_lo)
            hi = min(rec.hi_key, span_hi)
            if hi < lo:
                continue
            if best is None or rec.launches > best.launches:
                best = HeatRecord(name, lo, hi, rec.launches, rec.rows, rec.pages)
        if best is None:
            continue
        cold = [int(s) for s in np.argsort(shard_w, kind="stable") if int(s) != hot]
        targets = tuple(cold[: max(1, int(max_replicas))])
        if not targets:
            continue
        replicas[name] = (
            ReplicaRange(
                order=name,
                lo_key=int(best.lo_key),
                hi_key=int(best.hi_key),
                home=hot,
                replicas=targets,
            ),
        )
    return Placement(boundaries=boundaries, replicas=replicas)
