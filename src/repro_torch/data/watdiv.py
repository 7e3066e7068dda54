"""WatDiv-like synthetic RDF dataset + diverse BGP query workload (the
port's copy of ``repro.data.watdiv``: the same numpy RNG stream, so the
same scale and seed give the same triples and the same queries).

The paper's experiments use the Waterloo SPARQL Diversity Test Suite
(WatDiv) 10M-triple dataset and 145 BGP queries drawn uniformly at random
from its stress-test workload (section 5.2). WatDiv itself is not
available offline, so this module generates a *structurally analogous*
e-commerce graph (users, products, reviews, retailers, genres, cities)
with zipfian degree distributions, plus a stress-style query workload
covering WatDiv's four template families:

  L (linear/path), S (star), F (snowflake), C (complex).

Scale is configurable; benchmarks default to ~100K triples so the full
TPF-client request explosion stays tractable on one CPU core. The
relative TPF-vs-brTPF effects the paper reports are scale-free (they are
driven by intermediate-result sizes, which the zipfian skew preserves).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.bgp import BGP, parse_bgp
from ..core.rdf import TermDictionary
from ..core.store import TripleStore


@dataclasses.dataclass
class WatDivScale:
    users: int = 1000
    products: int = 500
    reviews: int = 1500
    retailers: int = 20
    genres: int = 25
    cities: int = 40
    tags: int = 60
    likes_per_user: float = 4.0
    friends_per_user: float = 2.0
    zipf_a: float = 1.6          # product-popularity skew


@dataclasses.dataclass
class WatDivData:
    dictionary: TermDictionary
    store: TripleStore
    scale: WatDivScale

    @property
    def num_triples(self) -> int:
        return len(self.store)


def from_arrays(triples: np.ndarray,
                terms: Sequence[str]) -> Tuple[TermDictionary, TripleStore]:
    """The port's dictionary and store over an existing encoded dataset.

    ``triples`` is the int32 ``[N, 3]`` dictionary-encoded triple array
    and ``terms`` the term strings in id order -- the whole state of a
    brTPF server. This is how a dataset built by the JAX package (or
    loaded from disk) is carried over: both packages then serve the same
    store.
    """
    d = TermDictionary()
    for term in terms:
        d.intern(term)
    if len(d) != len(terms):
        raise ValueError("terms must be distinct")
    return d, TripleStore(np.asarray(triples, dtype=np.int32))


def _zipf_choice(rng, n, size, a):
    """Zipf-skewed choice over range(n)."""
    ranks = rng.zipf(a, size=size)
    return np.minimum(ranks - 1, n - 1).astype(np.int64)


def generate(scale: Optional[WatDivScale] = None,
             seed: int = 0) -> WatDivData:
    if scale is None:
        scale = WatDivScale()
    rng = np.random.default_rng(seed)
    d = TermDictionary()
    rows: List[Tuple[int, int, int]] = []

    # entity ids
    users = [d.intern(f"user{i}") for i in range(scale.users)]
    prods = [d.intern(f"product{i}") for i in range(scale.products)]
    revs = [d.intern(f"review{i}") for i in range(scale.reviews)]
    rets = [d.intern(f"retailer{i}") for i in range(scale.retailers)]
    genres = [d.intern(f"genre{i}") for i in range(scale.genres)]
    cities = [d.intern(f"city{i}") for i in range(scale.cities)]
    tags = [d.intern(f"tag{i}") for i in range(scale.tags)]
    ratings = [d.intern(f"rating{i}") for i in range(1, 6)]

    # predicates / classes
    TYPE = d.intern("type")
    LIKES = d.intern("likes")
    FRIEND = d.intern("friendOf")
    LIVES = d.intern("livesIn")
    GENRE = d.intern("hasGenre")
    TAG = d.intern("hasTag")
    SOLD = d.intern("soldBy")
    REVIEWS = d.intern("reviewsProduct")
    AUTHOR = d.intern("hasAuthor")
    RATING = d.intern("hasRating")
    C_USER, C_PROD, C_REV, C_RET = (d.intern(c) for c in
                                    ("User", "Product", "Review",
                                     "Retailer"))

    add = rows.append
    for u in users:
        add((u, TYPE, C_USER))
        add((u, LIVES, cities[int(rng.integers(len(cities)))]))
        n_likes = 1 + rng.poisson(scale.likes_per_user - 1)
        for p_idx in _zipf_choice(rng, len(prods), n_likes, scale.zipf_a):
            add((u, LIKES, prods[int(p_idx)]))
        n_fr = rng.poisson(scale.friends_per_user)
        for f_idx in rng.integers(0, len(users), n_fr):
            if users[int(f_idx)] != u:
                add((u, FRIEND, users[int(f_idx)]))
    for p in prods:
        add((p, TYPE, C_PROD))
        add((p, GENRE, genres[int(_zipf_choice(rng, len(genres), 1, 1.4)[0])]))
        add((p, SOLD, rets[int(rng.integers(len(rets)))]))
        for t_idx in rng.choice(len(tags), size=int(rng.integers(1, 4)),
                                replace=False):
            add((p, TAG, tags[int(t_idx)]))
    for r in revs:
        add((r, TYPE, C_REV))
        add((r, REVIEWS,
             prods[int(_zipf_choice(rng, len(prods), 1, scale.zipf_a)[0])]))
        add((r, AUTHOR, users[int(rng.integers(len(users)))]))
        add((r, RATING, ratings[int(rng.integers(len(ratings)))]))
    for rt in rets:
        add((rt, TYPE, C_RET))

    triples = np.asarray(rows, dtype=np.int32)
    return WatDivData(d, TripleStore(triples), scale)


# ---------------------------------------------------------------------------
# Stress-style query workload (four WatDiv template families)
# ---------------------------------------------------------------------------

_TEMPLATES = [
    # -- L: linear / path ---------------------------------------------------
    ("L1", "?u likes ?p\n?p hasGenre {genre}"),
    ("L2", "?u friendOf ?v\n?v livesIn {city}"),
    ("L3", "?r reviewsProduct ?p\n?p soldBy {retailer}"),
    ("L4", "?u friendOf ?v\n?v likes ?p\n?p hasGenre {genre}"),
    # -- S: star ------------------------------------------------------------
    ("S1", "?p hasGenre {genre}\n?p soldBy ?r\n?p hasTag ?t"),
    ("S2", "?u type User\n?u livesIn {city}\n?u likes ?p"),
    ("S3", "?r reviewsProduct {product}\n?r hasRating ?g\n?r hasAuthor ?u"),
    ("S4", "?p type Product\n?p hasTag {tag}\n?p soldBy ?ret"),
    # -- F: snowflake ---------------------------------------------------------
    ("F1", "?r reviewsProduct ?p\n?r hasAuthor ?u\n?p hasGenre {genre}\n"
           "?u livesIn ?c"),
    ("F2", "?u likes ?p\n?u livesIn {city}\n?p soldBy ?ret\n?p hasTag ?t"),
    ("F3", "?r reviewsProduct ?p\n?r hasRating {rating}\n?p hasGenre ?g\n"
           "?p soldBy {retailer}"),
    # -- C: complex -----------------------------------------------------------
    ("C1", "?u likes ?p\n?r reviewsProduct ?p\n?r hasAuthor ?v\n"
           "?v livesIn {city}\n?p hasGenre ?g"),
    ("C2", "?u friendOf ?v\n?u likes ?p\n?v likes ?p\n?p hasGenre {genre}"),
    ("C3", "?r reviewsProduct ?p\n?r hasAuthor ?u\n?u friendOf ?v\n"
           "?p hasTag {tag}\n?r hasRating {rating}"),
]


def generate_workload(data: WatDivData, num_queries: int = 145,
                      seed: int = 1) -> List[Tuple[str, BGP]]:
    """Draw queries uniformly at random from the template families with
    random constant instantiation (the paper's 145-query selection)."""
    rng = np.random.default_rng(seed)
    s = data.scale
    out: List[Tuple[str, BGP]] = []
    for _ in range(num_queries):
        name, tmpl = _TEMPLATES[int(rng.integers(len(_TEMPLATES)))]
        q = tmpl.format(
            genre=f"genre{int(_zipf_choice(rng, s.genres, 1, 1.4)[0])}",
            city=f"city{int(rng.integers(s.cities))}",
            retailer=f"retailer{int(rng.integers(s.retailers))}",
            product=f"product{int(_zipf_choice(rng, s.products, 1, 1.6)[0])}",
            tag=f"tag{int(rng.integers(s.tags))}",
            rating=f"rating{int(rng.integers(1, 6))}",
        )
        out.append((name, parse_bgp(q, data.dictionary)))
    return out
