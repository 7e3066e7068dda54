"""The benchmark's synthetic data and query streams, drawn from a seed in
a few vectorised numpy calls.

The distributions are those of the port's own e-commerce generator,
``data/watdiv.py`` (which calls itself WatDiv-like; it is not WatDiv)
(users, products, reviews, retailers, genres, cities, tags and five
ratings; Zipf product popularity and genres, uniform cities, retailers,
authors, tags and ratings), and the term ids are laid out in the same
order, so a term's name gives its id without a dictionary. Only the
random stream differs: one draw per distribution instead of one Python
call per entity. This module imports nothing of the system under test.

A configuration file gives the scale (``scale``: entity counts and the
degree parameters); a traffic mix gives the query templates and how
their constants are drawn (``templates``, ``constants``).
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from . import rowkeys

# Entity classes in id order, and the name each id has: ``user{i}`` ...;
# ratings are named from 1.
ENTITIES = ("user", "product", "review", "retailer", "genre", "city", "tag",
            "rating")
SCALE_KEYS = {"user": "users", "product": "products", "review": "reviews",
              "retailer": "retailers", "genre": "genres", "city": "cities",
              "tag": "tags"}
RATINGS = 5
PREDICATES = ("type", "likes", "friendOf", "livesIn", "hasGenre", "hasTag",
              "soldBy", "reviewsProduct", "hasAuthor", "hasRating")
CLASSES = ("User", "Product", "Review", "Retailer")

# The triples are int32: ids 0 .. MAX_TERMS - 1.
MAX_TERMS = (1 << 31) - 1
# The least width of a field of the three-field key.
KEY_FIELD_BITS = 21


def sorted_distinct(keys: np.ndarray) -> np.ndarray:
    """``np.unique`` of a 1-D array by a sort (numpy 2.3's hash-based
    ``unique`` takes seconds more on ten million keys)."""
    keys = np.sort(keys)
    return keys[np.concatenate(([True], keys[1:] != keys[:-1]))] \
        if keys.size else keys


def seed_sequence(seed: int, *words: int) -> np.random.SeedSequence:
    """A numpy seed sequence from any whole number (the driver's seeds
    pass 32 bits) and further stream words."""
    return np.random.SeedSequence([int(seed) % (1 << 64), *words])


class Layout:
    """Term ids of one scale: each entity class a contiguous block, then
    the predicates, then the classes (the port generator's order)."""

    def __init__(self, scale: Dict[str, float]) -> None:
        self.scale = scale
        self.first: Dict[str, int] = {}
        self.count: Dict[str, int] = {}
        nxt = 0
        for kind in ENTITIES:
            n = RATINGS if kind == "rating" else int(scale[SCALE_KEYS[kind]])
            self.first[kind], self.count[kind] = nxt, n
            nxt += n
        self.pred = {p: nxt + i for i, p in enumerate(PREDICATES)}
        nxt += len(PREDICATES)
        self.cls = {c: nxt + i for i, c in enumerate(CLASSES)}
        self.num_terms = nxt + len(CLASSES)
        if self.num_terms > MAX_TERMS:
            raise ValueError(f"{self.num_terms} terms exceed the "
                             f"{MAX_TERMS} that int32 triples hold")

    def terms(self) -> List[str]:
        """Every term's name, in id order."""
        out: List[str] = []
        for kind in ENTITIES:
            base = 1 if kind == "rating" else 0
            out.extend(f"{kind}{i + base}" for i in range(self.count[kind]))
        return out + list(PREDICATES) + list(CLASSES)

    def term_id(self, name: str) -> int:
        if name in self.pred:
            return self.pred[name]
        if name in self.cls:
            return self.cls[name]
        m = re.fullmatch(r"([a-z]+)(\d+)", name)
        if m is None or m.group(1) not in self.first:
            raise ValueError(f"unknown term {name!r}")
        i = int(m.group(2)) - (1 if m.group(1) == "rating" else 0)
        if not 0 <= i < self.count[m.group(1)]:
            raise ValueError(f"term {name!r} is outside the scale")
        return self.first[m.group(1)] + i


def zipf_index(rng: np.random.Generator, n: int, size: int,
               a: float) -> np.ndarray:
    """Zipf-skewed indices into range(n), as the port's generator draws
    them: rank - 1, ranks past n folded onto n - 1."""
    return np.minimum(rng.zipf(a, size=size) - 1, n - 1).astype(np.int64)


def _distinct_three(rng: np.random.Generator, n: int,
                    size: int) -> np.ndarray:
    """Three distinct indices into range(n) per row, uniform over the
    ordered triples (sampling without replacement)."""
    a = rng.integers(n, size=size)
    b = rng.integers(n - 1, size=size)
    b += b >= a
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    c = rng.integers(n - 2, size=size)
    c += c >= lo
    c += c >= hi
    return np.stack([a, b, c], axis=1)


def generate(scale: Dict[str, float], seed: int) -> Tuple[np.ndarray, Layout]:
    """The dataset of ``scale`` from ``seed``: distinct int32 ``[N, 3]``
    triples sorted in subject, predicate, object order, and the layout
    that names their terms."""
    lay = Layout(scale)
    rng = np.random.default_rng(seed_sequence(seed, 0))
    f, c, pr, cl = lay.first, lay.count, lay.pred, lay.cls
    nu, npr, nr = c["user"], c["product"], c["review"]
    users = f["user"] + np.arange(nu)
    prods = f["product"] + np.arange(npr)
    revs = f["review"] + np.arange(nr)
    rets = f["retailer"] + np.arange(c["retailer"])
    zipf_a = float(scale["zipf_a"])
    genre_a = float(scale["genre_zipf_a"])
    parts: List[Tuple[np.ndarray, int, np.ndarray]] = []

    def add(s, p, o):
        parts.append((np.asarray(s), p, np.asarray(o)))

    add(users, pr["type"], np.full(nu, cl["User"]))
    add(users, pr["livesIn"], f["city"] + rng.integers(c["city"], size=nu))
    n_likes = 1 + rng.poisson(float(scale["likes_per_user"]) - 1, size=nu)
    add(np.repeat(users, n_likes), pr["likes"],
        f["product"] + zipf_index(rng, npr, int(n_likes.sum()), zipf_a))
    n_fr = rng.poisson(float(scale["friends_per_user"]), size=nu)
    fr_s = np.repeat(users, n_fr)
    fr_o = f["user"] + rng.integers(nu, size=int(n_fr.sum()))
    add(fr_s[fr_s != fr_o], pr["friendOf"], fr_o[fr_s != fr_o])

    add(prods, pr["type"], np.full(npr, cl["Product"]))
    add(prods, pr["hasGenre"],
        f["genre"] + zipf_index(rng, c["genre"], npr, genre_a))
    add(prods, pr["soldBy"], f["retailer"] + rng.integers(c["retailer"],
                                                         size=npr))
    n_tags = rng.integers(1, 4, size=npr)
    tags = _distinct_three(rng, c["tag"], npr)
    keep = np.arange(3)[None, :] < n_tags[:, None]
    add(np.broadcast_to(prods[:, None], tags.shape)[keep], pr["hasTag"],
        f["tag"] + tags[keep])

    add(revs, pr["type"], np.full(nr, cl["Review"]))
    add(revs, pr["reviewsProduct"],
        f["product"] + zipf_index(rng, npr, nr, zipf_a))
    add(revs, pr["hasAuthor"], f["user"] + rng.integers(nu, size=nr))
    add(revs, pr["hasRating"], f["rating"] + rng.integers(RATINGS, size=nr))
    add(rets, pr["type"], np.full(len(rets), cl["Retailer"]))

    bits = max(KEY_FIELD_BITS, (lay.num_terms - 1).bit_length())
    if 3 * bits <= rowkeys.KEY_BITS:
        # ids of 21 bits (every configuration here): three equal fields
        # in one key, the cheapest sort
        keys = sorted_distinct(np.concatenate([
            (s.astype(np.int64) << (2 * bits)) | (p << bits)
            | o.astype(np.int64) for s, p, o in parts]))
        mask = (1 << bits) - 1
        triples = np.stack([keys >> (2 * bits), (keys >> bits) & mask,
                            keys & mask], axis=1).astype(np.int32)
        return triples, lay
    cols = [np.concatenate([s for s, _, _ in parts], dtype=np.int32),
            np.concatenate([np.full(len(s), p, dtype=np.int32)
                            for s, p, _ in parts]),
            np.concatenate([o for _, _, o in parts], dtype=np.int32)]
    del parts[:]
    return np.stack(rowkeys.sorted_rows(cols, distinct=True), axis=1), lay


# ---------------------------------------------------------------------------
# Query streams
# ---------------------------------------------------------------------------

_SLOT = re.compile(r"\{(\w+)\}")


def encode_query(text: str, lay: Layout) -> np.ndarray:
    """A template instance as int ``[n, 3]`` pattern components:
    constants are term ids (>= 0), the k-th distinct variable is
    ``-(k + 1)``."""
    vars_: Dict[str, int] = {}
    rows = []
    for line in text.strip().splitlines():
        toks = line.split()
        if len(toks) != 3:
            raise ValueError(f"bad triple pattern {line!r}")
        row = []
        for tok in toks:
            if tok.startswith("?"):
                row.append(-(vars_.setdefault(tok, len(vars_)) + 1))
            else:
                row.append(lay.term_id(tok))
        rows.append(row)
    return np.asarray(rows, dtype=np.int64)


def draw_constant(rng: np.random.Generator, spec: Dict, lay: Layout) -> str:
    """One constant's name, drawn as the mix's ``constants`` entry says:
    ``{"kind": <entity class>, "dist": "zipf" | "uniform", "a": ...}``."""
    kind = spec["kind"]
    n = lay.count[kind]
    if spec["dist"] == "zipf":
        i = int(zipf_index(rng, n, 1, float(spec["a"]))[0])
    elif spec["dist"] == "uniform":
        i = int(rng.integers(n))
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return f"{kind}{i + (1 if kind == 'rating' else 0)}"


def client_stream(mix: Dict, lay: Layout, seed: int, phase: int,
                  client: int) -> Iterator[Tuple[str, np.ndarray]]:
    """Client ``client``'s endless query stream in ``phase`` (0 warm-up,
    1 the measured window).

    The mix has ``clients`` streams, and they are the same for every run
    seed: stream ``k`` goes round the templates from offset ``k``, each
    query's constants drawn from the stream's own generator, seeded by
    the mix's ``streams_seed``, the phase and ``k``. The run seed only
    deals the streams out to the clients (a permutation), so every seed
    offers the same queries in another order, and the data, made from
    the seed, is what differs."""
    n = int(mix["clients"])
    deal = np.random.default_rng(seed_sequence(seed, 1, phase)).permutation(n)
    k = int(deal[client])
    rng = np.random.default_rng(
        np.random.SeedSequence([int(mix["streams_seed"]), phase, k]))
    names: Sequence[str] = list(mix["templates"])
    i = k
    while True:
        name = names[i % len(names)]
        i += 1
        text = _SLOT.sub(
            lambda m: draw_constant(rng, mix["constants"][m.group(1)], lay),
            mix["templates"][name])
        yield name, encode_query(text, lay)
