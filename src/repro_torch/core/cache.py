"""LRU HTTP-cache simulation (paper section 7).

The paper instruments the combined TPF/brTPF server to count the cache
hits an HTTP proxy (nginx) *would* achieve, for an unlimited cache or an
LRU cache bounded to a number of distinct requests. A request's cache key
is its full URL, i.e. (pattern, Omega sequence, page) -- brTPF requests
with different attached mappings are distinct cache entries, which is why
brTPF's hit potential is structurally lower (section 7.1).

Since the unified fragment store (``core/fragments.py``) an
:class:`LRUCache` handed to :class:`~repro_torch.core.server.BrTPFServer` is
*bound* to the server's :class:`~repro_torch.core.fragments.FragmentStore`:
this object keeps the section-7 accounting surface (``hits`` /
``misses`` / ``hit_rate``) and the capacity policy, while the pages
themselves live in the store's page layer -- the same entries the
selector memo slices, so eviction is coherent across layers and a
resident page skips its kernel/window launch regardless of which path
populated it. Unbound, the class behaves exactly as before (the
discrete-event simulation replays its shared proxy with a standalone
instance).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Hashable, Optional, Tuple


class LRUCache:
    """Counting LRU cache over hashable request keys.

    ``capacity=None`` simulates the unlimited cache of section 7.1.
    """

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self._entries: "OrderedDict[Hashable, object]" = OrderedDict()
        self._store = None   # optional FragmentStore backing (bind())

    def bind(self, store) -> None:
        """Become a view over ``store``'s page layer: keys and page
        values live there (one copy, coherent with the selector memo),
        this object keeps the hit/miss accounting and the capacity. The
        server calls this at construction; entries cached before
        binding are discarded."""
        self._store = store
        self._entries.clear()
        store.page_capacity = self.capacity

    def get(self, key: Hashable):
        if self._store is not None:
            val = self._store.http_get(key)
            if val is None:
                self.misses += 1
            else:
                self.hits += 1
            return val
        if key in self._entries:
            self.hits += 1
            self._entries.move_to_end(key)
            return self._entries[key]
        self.misses += 1
        return None

    def contains(self, key: Hashable) -> bool:
        """Non-counting peek (no hit/miss accounting, no LRU bump) --
        used by the server's batch planner, which must not distort the
        cache metrics the paper reports."""
        if self._store is not None:
            return self._store.http_contains(key)
        return key in self._entries

    def put(self, key: Hashable, value: object) -> None:
        if self._store is not None:
            # track capacity live in case a caller resized it
            self._store.page_capacity = self.capacity
            self._store.http_put(key, value)
            return
        self._entries[key] = value
        self._entries.move_to_end(key)
        if self.capacity is not None and len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def __len__(self) -> int:
        if self._store is not None:
            return self._store.num_pages
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


def request_key(pattern_tuple: Tuple[int, int, int],
                omega_rows: Optional[tuple],
                page: int) -> Hashable:
    """Canonical cache key: the request 'URL'.

    ``omega_rows`` must be a tuple of row-tuples in *sequence order* --
    two requests with the same mappings in different order are different
    URLs, exactly as for the paper's GET-parameter encoding.
    """
    return (pattern_tuple, omega_rows, page)
