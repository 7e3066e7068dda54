"""Unified fragment store: one cache-coherent page layer for every cache.

Section 7 of the paper shows HTTP caching is where brTPF structurally
pays (distinct Omega attachments make distinct URLs, so proxy hit rates
drop versus TPF) -- which makes every *other* reuse layer matter more.
Before this module the repo had four independent caches that could not
see each other: the server's HTTP :class:`~repro_torch.core.cache.LRUCache`,
the server's inline selector memo, the store's candidate-range memo and
the two copy-pasted client-side GET caches. :class:`FragmentStore`
replaces all of their hand-rolled OrderedDicts with one page-granular
store, one eviction policy and one accounting surface, so a kernel or
sharded window launch is skipped whenever the requested page is already
resident -- regardless of which path populated it -- and eviction is
coherent across layers instead of accidental.

A fragment is identified by its page-independent key ``(pattern_tuple,
omega_rows)`` (:func:`fragment_key`; a request URL minus the page
number). Each entry can hold two kinds of residency:

* **data** -- the fragment's full selector result (the selector-memo
  layer; for the triple store's range memo the payload is a lazy
  :class:`~repro_torch.core.store.CandidateRange` instead). Any page of a
  data-resident fragment can be served by slicing, without a kernel or
  window launch.
* **pages** -- individual rendered page objects (the HTTP-cache layer;
  also the client-side GET cache). A page stays servable after the full
  data was evicted.

Eviction is coherent by construction: the page a bound HTTP cache
serves *is* the entry's page (evicting the HTTP entry drops the memo's
page and vice versa -- :meth:`FragmentStore.evict` drops both layers),
and when an entry's last resource goes the per-pattern refcount drops,
firing ``on_release(pattern_tuple)`` so the server can evict the
store's candidate range for a pattern no fragment is streaming anymore.

Accounting surfaces (the section-7 caveat): ``hits``/``misses`` count
*data-layer* (memo) lookups and ``page_hits``/``page_misses`` count
*page-layer* (HTTP) lookups, separately -- memo-only traffic must not
distort the HTTP hit accounting the paper reports, and the page layer
only ever serves pages that were explicitly registered through the HTTP
path, never pages merely derivable from memo data.
``launches_skipped`` counts origin computations avoided by residency on
an accelerated selector backend.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Hashable, Optional, Tuple

import numpy as np

DEFAULT_MEMO_CAPACITY = 256


def fragment_key(pattern_tuple: Tuple[int, int, int],
                 omega: Optional[np.ndarray]) -> Tuple:
    """Page-independent fragment identity: (pattern, Omega sequence).

    Matches the first two components of :func:`~repro_torch.core.cache.
    request_key`, so ``request_key(p, om, page)[:2] == fragment_key(p,
    omega)`` -- the server, the selectors and the clients all address
    the same entry for the same fragment.
    """
    om = None
    if omega is not None:
        om = tuple(map(tuple, np.asarray(omega).tolist()))
    return (pattern_tuple, om)


@dataclasses.dataclass
class FragmentEntry:
    """One fragment's residency: optional full data + rendered pages."""

    key: Tuple
    data: object = None                    # full selector result payload
    pages: "OrderedDict[int, object]" = dataclasses.field(
        default_factory=OrderedDict)

    @property
    def empty(self) -> bool:
        return self.data is None and not self.pages


class FragmentStore:
    """Page-granular LRU fragment store with two coherent layers.

    ``memo_capacity`` bounds data-resident entries (LRU over data
    residency). ``page_capacity`` bounds pages (LRU over pages; ``None``
    = unlimited, the section-7.1 unlimited cache). ``weigh(payload)``
    optionally bounds total payload weight by ``max_rows`` (the
    candidate-range memo's retained-row bound; the newest entry is
    always kept). ``on_release(pattern_tuple)`` fires when the last
    entry for a pattern is removed from both layers.
    """

    def __init__(self, memo_capacity: int = DEFAULT_MEMO_CAPACITY,
                 page_capacity: Optional[int] = None,
                 max_rows: Optional[int] = None,
                 weigh: Optional[Callable[[object], int]] = None,
                 on_release: Optional[Callable[[Tuple], object]] = None,
                 ) -> None:
        self.memo_capacity = int(memo_capacity)
        self.page_capacity = page_capacity
        self.max_rows = max_rows
        self.weigh = weigh
        self.on_release = on_release
        self._entries: dict = {}
        self._data_lru: "OrderedDict[Tuple, None]" = OrderedDict()
        self._page_lru: "OrderedDict[Tuple, None]" = OrderedDict()
        self._pattern_refs: dict = {}
        self.hits = 0            # data-layer (memo) lookups
        self.misses = 0
        self.page_hits = 0       # page-layer (HTTP) lookups
        self.page_misses = 0
        self.launches_skipped = 0

    # -- data layer (selector memo / range memo) -----------------------------

    def get_data(self, key: Tuple, count_miss: bool = True):
        """Counting data lookup: payload or None; bumps LRU, re-trims
        the weight bound (payloads can grow lazily after insert).

        ``count_miss=False`` is the probe variant: a present payload is
        still a (counted) hit, but an absent one charges nothing --
        probe traffic that will not populate the entry must not distort
        the miss accounting of the layers that do."""
        entry = self._entries.get(key)
        if entry is None or entry.data is None:
            if count_miss:
                self.misses += 1
            return None
        self.hits += 1
        self._data_lru.move_to_end(key)
        if self.weigh is not None:
            self._trim_data()
        return entry.data

    def peek_data(self, key: Tuple, touch: bool = False):
        """Non-counting data lookup (no hit/miss accounting); ``touch``
        bumps the LRU position -- used by selectors consulting the store
        before a launch, which must not double-count the server's own
        memo accounting for the same request."""
        entry = self._entries.get(key)
        if entry is None or entry.data is None:
            return None
        if touch:
            self._data_lru.move_to_end(key)
        return entry.data

    def contains_data(self, key: Tuple) -> bool:
        """Non-counting, non-bumping residency peek (batch planner)."""
        entry = self._entries.get(key)
        return entry is not None and entry.data is not None

    def put_data(self, key: Tuple, payload: object) -> None:
        entry = self._require(key)
        if entry.data is None:
            self._data_lru[key] = None
        entry.data = payload
        self._data_lru.move_to_end(key)
        self._trim_data()

    # -- page layer (HTTP cache view / client GET cache) ---------------------

    @staticmethod
    def _split(request_key: Tuple) -> Tuple[Tuple, Hashable]:
        """(pattern, omega, page) request key -> (fragment key, page)."""
        return request_key[:2], request_key[2]

    def http_get(self, request_key: Tuple):
        """Counting page lookup. Only pages registered via
        :meth:`http_put` are served -- a page merely derivable from
        resident memo data is a *miss* here, exactly as for the paper's
        proxy (memo traffic must not inflate HTTP hit counts)."""
        key, page = self._split(request_key)
        entry = self._entries.get(key)
        if entry is None or page not in entry.pages:
            self.page_misses += 1
            return None
        self.page_hits += 1
        self._page_lru.move_to_end((key, page))
        return entry.pages[page]

    def http_contains(self, request_key: Tuple) -> bool:
        """Non-counting peek (no hit/miss accounting, no LRU bump)."""
        key, page = self._split(request_key)
        entry = self._entries.get(key)
        return entry is not None and page in entry.pages

    def http_put(self, request_key: Tuple, value: object) -> None:
        key, page = self._split(request_key)
        entry = self._require(key)
        entry.pages[page] = value
        self._page_lru[(key, page)] = None
        self._page_lru.move_to_end((key, page))
        self._trim_pages()

    @property
    def num_pages(self) -> int:
        return len(self._page_lru)

    # -- residency / skip accounting ------------------------------------------

    def page_resident(self, request_key: Tuple) -> bool:
        """Can this page be served without origin selector work, from
        ANY layer (full data or a registered page)? Non-counting."""
        key, page = self._split(request_key)
        entry = self._entries.get(key)
        if entry is None:
            return False
        return entry.data is not None or page in entry.pages

    def note_skip(self) -> None:
        """Record one kernel/window launch avoided by residency."""
        self.launches_skipped += 1

    # -- eviction --------------------------------------------------------------

    def evict(self, key: Tuple) -> bool:
        """Coherently drop a whole fragment entry: its memo data AND
        every page (the HTTP view loses the pages too -- single
        storage). Returns True if anything was present."""
        entry = self._entries.get(key)
        if entry is None:
            return False
        if entry.data is not None:
            entry.data = None
            self._data_lru.pop(key, None)
        for page in list(entry.pages):
            self._page_lru.pop((key, page), None)
        entry.pages.clear()
        self._remove_if_empty(key, entry)
        return True

    def evict_page(self, request_key: Tuple) -> bool:
        key, page = self._split(request_key)
        entry = self._entries.get(key)
        if entry is None or page not in entry.pages:
            return False
        del entry.pages[page]
        self._page_lru.pop((key, page), None)
        self._remove_if_empty(key, entry)
        return True

    def trim(self) -> None:
        """Re-enforce both capacity bounds (after a temporary widening,
        e.g. the server's batch-lifetime memo extension)."""
        self._trim_data()
        self._trim_pages()

    def clear(self) -> None:
        """Drop everything without firing ``on_release`` (a client
        cache reset between executions, not coherent eviction)."""
        self._entries.clear()
        self._data_lru.clear()
        self._page_lru.clear()
        self._pattern_refs.clear()

    def reset_counters(self) -> None:
        self.hits = self.misses = 0
        self.page_hits = self.page_misses = 0
        self.launches_skipped = 0

    # -- introspection ---------------------------------------------------------

    @property
    def data_entries(self) -> int:
        return len(self._data_lru)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def page_hit_rate(self) -> float:
        total = self.page_hits + self.page_misses
        return self.page_hits / total if total else 0.0

    def data_payloads(self) -> dict:
        """{fragment key -> payload} view of the data layer."""
        return {k: self._entries[k].data for k in self._data_lru}

    # -- internals -------------------------------------------------------------

    def _require(self, key: Tuple) -> FragmentEntry:
        entry = self._entries.get(key)
        if entry is None:
            entry = FragmentEntry(key=key)
            self._entries[key] = entry
            pattern = key[0]
            self._pattern_refs[pattern] = \
                self._pattern_refs.get(pattern, 0) + 1
        return entry

    def _remove_if_empty(self, key: Tuple, entry: FragmentEntry) -> None:
        if not entry.empty:
            return
        del self._entries[key]
        pattern = key[0]
        refs = self._pattern_refs.get(pattern, 1) - 1
        if refs:  # another live fragment still streams this pattern
            self._pattern_refs[pattern] = refs
            return
        self._pattern_refs.pop(pattern, None)
        if self.on_release is not None:
            self.on_release(pattern)

    def _drop_data(self, key: Tuple) -> None:
        entry = self._entries[key]
        entry.data = None
        del self._data_lru[key]
        self._remove_if_empty(key, entry)

    def _trim_data(self) -> None:
        if self.weigh is not None:
            # Payloads pin weight lazily (a consumer may have
            # materialized since insert), so retained weight is
            # recounted here; the newest entry is always kept.
            weight = sum(self.weigh(self._entries[k].data)
                         for k in self._data_lru)
            while len(self._data_lru) > 1 and (
                    len(self._data_lru) > self.memo_capacity
                    or (self.max_rows is not None
                        and weight > self.max_rows)):
                oldest = next(iter(self._data_lru))
                weight -= self.weigh(self._entries[oldest].data)
                self._drop_data(oldest)
            return
        while len(self._data_lru) > self.memo_capacity:
            self._drop_data(next(iter(self._data_lru)))

    def _trim_pages(self) -> None:
        if self.page_capacity is None:
            return
        while len(self._page_lru) > self.page_capacity:
            (key, page), _ = self._page_lru.popitem(last=False)
            entry = self._entries.get(key)
            if entry is None:
                continue
            entry.pages.pop(page, None)
            self._remove_if_empty(key, entry)


class ClientFragmentCache:
    """The per-execution client-side GET cache, shared by the sync and
    async clients (formerly two copy-pasted ``_client_cache`` dicts).

    Built on :class:`FragmentStore`'s page layer: one rendered page per
    request key, unlimited capacity, cleared per ``execute()`` (the
    paper restarts the client process between query executions). The
    Node.js ldf-client caches GET responses the same way; without it the
    TPF algorithm's repeated first-page probes would dominate #req.
    """

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.store = FragmentStore(page_capacity=None)

    def get(self, request_key: Tuple):
        if not self.enabled:
            return None
        return self.store.http_get(request_key)

    def put(self, request_key: Tuple, fragment: object) -> None:
        if self.enabled:
            self.store.http_put(request_key, fragment)

    def clear(self) -> None:
        self.store.clear()

    @property
    def hits(self) -> int:
        return self.store.page_hits

    @property
    def misses(self) -> int:
        return self.store.page_misses

    def __len__(self) -> int:
        return self.store.num_pages
