"""The benchmark's data and reference on the CPU: the bulk generator
against the port's ``data/watdiv.py`` distributions, the query streams,
and the NumPy reference against the port's numpy backend, fragment for
fragment, and against its brTPF client's solutions."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from bench import reference, datagen, rowkeys

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "bench" / "configs"
                     / "ecom9m-kernel.json").read_text())
MIXES = {p.stem: json.loads(p.read_text())
         for p in (ROOT / "bench" / "mixes").glob("*.json")}


def small_scale(factor: int) -> dict:
    """The configured scale over 600, times ``factor`` (the port
    generator's default at factor 1)."""
    out = dict(CONFIG["dataset"]["scale"])
    for k in ("users", "products", "reviews", "retailers", "genres",
              "cities", "tags"):
        out[k] = out[k] // 600 * factor
    return out


@pytest.fixture(scope="module")
def port_watdiv():
    from repro_torch.data import watdiv
    return watdiv


def test_layout_names_every_term_as_the_port_generator_does(port_watdiv):
    scale = small_scale(1)
    data = port_watdiv.generate(port_watdiv.WatDivScale(), seed=0)
    lay = datagen.Layout(scale)
    terms = lay.terms()
    assert len(terms) == len(data.dictionary) == lay.num_terms
    assert all(data.dictionary.term(i) == t for i, t in enumerate(terms))
    assert lay.term_id("rating5") == data.dictionary.lookup("rating5")
    with pytest.raises(ValueError):
        lay.term_id("user1000")


def test_bulk_generator_draws_the_port_generators_distributions(
        port_watdiv):
    """Per predicate, triple counts within 3% of the port generator's at
    20x its default scale, and the Zipf heads (most liked product, most
    used genre) within 10% of their share."""
    scale = small_scale(20)
    port = port_watdiv.generate(port_watdiv.WatDivScale(**{
        k: v for k, v in scale.items() if k != "genre_zipf_a"}), seed=3)
    mine, lay = datagen.generate(scale, 3)
    theirs = port.store.triples
    assert mine.shape[1] == 3 and mine.dtype == np.int32
    assert (np.unique(mine, axis=0) == mine).all()      # sorted, distinct
    for name, pid in lay.pred.items():
        a = int((mine[:, 1] == pid).sum())
        b = int((theirs[:, 1] == pid).sum())
        assert abs(a - b) <= 0.03 * b, (name, a, b)
    for pred, kind in (("likes", "product"), ("hasGenre", "genre")):
        pid, head = lay.pred[pred], lay.first[kind]
        a = (mine[mine[:, 1] == pid][:, 2] == head).mean()
        b = (theirs[theirs[:, 1] == pid][:, 2] == head).mean()
        assert abs(a - b) <= 0.1 * b, (pred, a, b)
    tags = mine[mine[:, 1] == lay.pred["hasTag"]]
    per_product = np.bincount(tags[:, 0] - lay.first["product"])
    assert set(per_product.tolist()) == {1, 2, 3}


def test_same_seed_same_data_large_seeds_differ():
    scale = small_scale(1)
    a, _ = datagen.generate(scale, 2**33 + 5)
    b, _ = datagen.generate(scale, 2**33 + 5)
    c, _ = datagen.generate(scale, 2**33 + 6)
    assert (a == b).all() and (a.shape != c.shape or (a != c).any())


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_client_streams_go_round_the_templates(mix):
    lay = datagen.Layout(small_scale(1))
    spec = MIXES[mix]
    names = list(spec["templates"])
    for client in (0, 5):
        stream = datagen.client_stream(spec, lay, 7, 1, client)
        got = [next(stream) for _ in range(2 * len(names))]
        k = names.index(got[0][0])
        assert [n for n, _ in got] == [names[(k + i) % len(names)]
                                      for i in range(2 * len(names))]
        for name, pats in got:
            assert pats.shape == (spec["templates"][name].count("\n") + 1,
                                  3)
            assert (pats < lay.num_terms).all()
    again = datagen.client_stream(spec, lay, 7, 1, 5)
    first = datagen.client_stream(spec, lay, 7, 1, 5)
    assert all((next(again)[1] == next(first)[1]).all() for _ in range(20))


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_every_seed_deals_the_same_streams(mix):
    """Two run seeds give the clients the same set of query streams in
    another order; the warm-up's streams are others."""
    lay = datagen.Layout(small_scale(1))
    spec = MIXES[mix]

    def streams(seed, phase):
        out = []
        for c in range(spec["clients"]):
            it = datagen.client_stream(spec, lay, seed, phase, c)
            out.append(tuple(next(it)[1].tobytes() for _ in range(4)))
        return out

    a, b = streams(2**40 + 1, 1), streams(2**40 + 2, 1)
    assert sorted(a) == sorted(b) and a != b
    assert not set(a) & set(streams(2**40 + 1, 0))


@pytest.fixture(scope="module")
def tiny():
    from repro_torch.core import BrTPFServer, ServerConfig
    from repro_torch.data import watdiv
    triples, lay = datagen.generate(small_scale(1), 11)
    _, store = watdiv.from_arrays(triples, lay.terms())
    server = BrTPFServer(store, ServerConfig(page_size=20))
    return triples, lay, server, reference.ReferenceStore(triples)


def test_reference_pages_equal_the_numpy_backends(tiny):
    """TPF requests of every template pattern and brTPF requests with
    mappings drawn from real matches (repeated, and leaving variables
    unbound), every page: data, cnt and has_next equal."""
    from repro_torch.core import Request, TriplePattern
    triples, lay, server, ref = tiny
    rng = np.random.default_rng(0)
    checked = 0
    for spec in MIXES.values():
        stream = datagen.client_stream(spec, lay, 1, 1, 0)
        for _ in range(3 * len(spec["templates"])):
            _name, pats = next(stream)
            nv = int(-pats.min())
            for tp in pats:
                tp = tuple(int(x) for x in tp)
                for omega in (None, _mappings(rng, ref, pats, nv)):
                    data, cnt = reference.fragment(ref, tp, omega)
                    for page in range(max(1, -(-data.shape[0] // 20)) + 1):
                        frag = server.handle(Request(
                            TriplePattern(*tp), omega, page))
                        want = reference.page(data, cnt, page, 20)
                        assert frag.data.tobytes() == want[0].tobytes()
                        assert (frag.cnt, frag.has_next) == want[1:]
                        checked += 1
    assert checked > 200


def _mappings(rng, ref, pats, nv):
    """Up to 30 mappings over ``nv`` variables: bindings of the first
    pattern's matches, some rows repeated, one variable left unbound."""
    first = ref.match(tuple(int(x) for x in pats[0]))
    if first.shape[0] == 0:
        return None
    rows = first[rng.integers(first.shape[0], size=12)]
    out = np.full((12, nv), -1, dtype=np.int32)
    for comp, c in enumerate(pats[0]):
        if c < 0:
            out[:, -int(c) - 1] = rows[:, comp]
    out[3] = out[2]
    return out


def test_reference_solutions_equal_the_port_clients(tiny):
    from repro_torch.core import BrTPFClient, bgp_from_arrays
    _, lay, server, ref = tiny
    for spec in MIXES.values():
        stream = datagen.client_stream(spec, lay, 2, 1, 0)
        for _ in range(len(spec["templates"])):
            _name, pats = next(stream)
            res = BrTPFClient(server).execute(bgp_from_arrays(pats.tolist()))
            want = reference.solutions(ref, pats)
            got = res.solutions
            assert got.shape == want.shape and (got == want).all()


# ---------------------------------------------------------------------------
# Term ids past 21 bits
# ---------------------------------------------------------------------------

def test_layout_takes_terms_past_21_bits():
    scale = dict(small_scale(1), users=1 << 21)
    lay = datagen.Layout(scale)
    assert lay.num_terms > 1 << 21
    terms = lay.terms()
    assert len(terms) == lay.num_terms and terms[-1] == "Retailer"
    assert lay.term_id("Retailer") == lay.num_terms - 1
    assert lay.term_id(f"user{(1 << 21) - 1}") == (1 << 21) - 1
    assert lay.term_id("rating5") == lay.first["rating"] + 4
    with pytest.raises(ValueError):
        datagen.Layout(dict(scale, users=1 << 31))


def _requests(ref, lay):
    """Every template pattern of both mixes, alone and with mappings."""
    rng = np.random.default_rng(0)
    out = []
    for spec in MIXES.values():
        stream = datagen.client_stream(spec, lay, 1, 1, 0)
        for _ in range(len(spec["templates"])):
            _name, pats = next(stream)
            omega = _mappings(rng, ref, pats, int(-pats.min()))
            out.extend((tuple(int(x) for x in tp), om, pats)
                       for tp in pats for om in (None, omega))
    return out


def _answers(ref, requests):
    """Each request's matches, fragment, third page and its BGP's
    solutions, as bytes."""
    out = []
    for tp, omega, pats in requests:
        data, cnt = reference.fragment(ref, tp, omega)
        out.append((ref.match(tp).tobytes(), data.tobytes(), cnt,
                    reference.page(data, cnt, 2, 20)[0].tobytes(),
                    reference.solutions(ref, pats).tobytes()))
    return out


@pytest.mark.parametrize("key_bits", [62, 0])
def test_wide_path_gives_the_narrow_paths_data_and_answers(tiny, key_bits,
                                                           monkeypatch):
    """At today's widths, the paths past three 21-bit fields give the
    same triples, matches, fragments and solutions: one key of fields
    as wide as each column's range (62 bits allowed), and the sort by
    ``np.lexsort`` with keys by rank (0 bits)."""
    triples, lay, _, ref = tiny
    requests = _requests(ref, lay)
    narrow = _answers(ref, requests)
    monkeypatch.setattr(rowkeys, "KEY_BITS", key_bits)
    assert (rowkeys._packing(list(triples.T)) is None) == (key_bits == 0)
    again, _ = datagen.generate(small_scale(1), 11)
    assert again.dtype == np.int32 and again.tobytes() == triples.tobytes()
    wide = reference.ReferenceStore(triples[::-1])
    assert wide.triples.tobytes() == ref.triples.tobytes()
    assert _answers(wide, requests) == narrow
    assert len(requests) > 50


POOLS = {"full": lambda top: [0, 1, 2, 7, (1 << 21) - 1, 1 << 21,
                              top // 2, top - 1, top],
         "band": lambda top: [top - (1 << 20), top - 5, top - 2, top - 1,
                              top]}


@pytest.fixture(params=[(t, s) for t in (1 << 30, (1 << 31) - 1)
                        for s in POOLS], ids=lambda p: f"{p[0]}-{p[1]}")
def wide_store(request):
    """A hand-made store whose ids reach ``top``: subjects and objects
    from a pool spanning the ids ("full": the wide path) or a band under
    ``top`` (one packed key), three predicates just under ``top``."""
    top, span = request.param
    rng = np.random.default_rng(top % 97)
    pool = np.asarray(POOLS[span](top), dtype=np.int64)
    preds = np.asarray([top - 2, top - 1, top], dtype=np.int64)
    t = np.stack([rng.choice(pool, 90), rng.choice(preds, 90),
                  rng.choice(pool, 90)], axis=1).astype(np.int32)
    ref = reference.ReferenceStore(t)
    want = sorted(set(map(tuple, t.tolist())))
    assert ref.triples.tolist() == [list(r) for r in want]
    assert (rowkeys._packing(list(t.T)) is None) == (span == "full")
    return want, ref, pool, preds


def _brute_match(triples, pattern):
    """Matches by a scan, in the order of the permutation (SPO, POS,
    OSP, the first with the longest bound prefix)."""
    rows = [r for r in triples
            if all(c < 0 or r[i] == c for i, c in enumerate(pattern))
            and all(r[i] == r[j] for i in range(3) for j in range(3)
                    if pattern[i] < 0 and pattern[i] == pattern[j])]
    best, order = -1, None
    for perm in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        plen = next((k for k, c in enumerate(perm) if pattern[c] < 0), 3)
        if plen > best:
            best, order = plen, perm
    return sorted(rows, key=lambda r: [r[c] for c in order])


def _patterns(triples, absent):
    """Every mix of bound and unbound components, the variables repeated
    or not, constants from a few triples and one absent id."""
    picks = [triples[0], triples[len(triples) // 2], triples[-1]]
    out = set()
    for base in picks:
        choices = [(base[i], absent, -1, -2, -3) for i in range(3)]
        for a in choices[0]:
            for b in choices[1]:
                for c in choices[2]:
                    out.add((a, b, c))
    return sorted(out)


def test_wide_ids_match_the_scan(wide_store):
    triples, ref, _, _ = wide_store
    for pattern in _patterns(triples, 12345):
        got = ref.match(pattern)
        assert got.dtype == np.int32
        assert got.tolist() == [list(r) for r in
                                _brute_match(triples, pattern)], pattern


def test_wide_ids_fragments_match_the_scan(wide_store):
    """Fragments with mappings (repeated, partly unbound): the scan's
    streams concatenated, each triple's first occurrence kept, ``cnt``
    their summed sizes, pages of 3."""
    triples, ref, pool, preds = wide_store
    rng = np.random.default_rng(1)
    for pattern in ((-1, int(preds[0]), -2), (-1, -2, -3),
                    (-1, int(preds[2]), -1), (int(pool[-1]), -2, -3)):
        for _ in range(4):
            omega = rng.choice(pool, size=(rng.integers(1, 9), 3))
            omega[rng.random(omega.shape) < 0.2] = -1
            omega[-1] = omega[0]
            insts = list(dict.fromkeys(
                tuple(int(om[-c - 1]) if c < 0 and om[-c - 1] >= 0 else c
                      for c in pattern) for om in omega.tolist()))
            streams = [_brute_match(triples, p) for p in insts]
            seen, data = set(), []
            for row in (r for s in streams for r in s):
                if row not in seen:
                    seen.add(row)
                    data.append(list(row))
            got, cnt = reference.fragment(ref, pattern, omega)
            assert got.tolist() == data
            assert cnt == sum(len(s) for s in streams)
            for k in range(len(data) // 3 + 2):
                page, c, more = reference.page(got, cnt, k, 3)
                assert page.tolist() == data[3 * k:3 * k + 3]
                assert (c, more) == (cnt, 3 * k + 3 < len(data))


def _brute_solutions(triples, patterns, nv):
    sols = {(-1,) * nv}
    for pattern in patterns:
        nxt = set()
        for sol in sols:
            inst = tuple(sol[-c - 1] if c < 0 and sol[-c - 1] >= 0 else c
                         for c in pattern)
            for r in _brute_match(triples, inst):
                s = list(sol)
                for i, c in enumerate(pattern):
                    if c < 0:
                        s[-c - 1] = r[i]
                nxt.add(tuple(s))
        sols = nxt
    return sorted(sols)


def test_wide_ids_solutions_match_the_scan(wide_store):
    """3-pattern BGPs, a path, a star and a cycle, against a scan that
    extends every solution by every matching triple."""
    triples, ref, pool, preds = wide_store
    p0, p1, p2 = (int(p) for p in preds)
    found = 0
    for bgp in ([(-1, p0, -2), (-2, p1, -3), (-3, p2, -4)],
                [(-1, p0, -2), (-1, p1, -3), (-1, p2, int(pool[-1]))],
                [(-1, p0, -2), (-2, -4, -3), (-3, p1, -1)]):
        pats = np.asarray(bgp, dtype=np.int64)
        nv = int(-pats.min())
        got = reference.solutions(ref, pats)
        want = _brute_solutions(triples, bgp, nv)
        assert got.dtype == np.int32
        assert got.tolist() == [list(s) for s in want], bgp
        found += len(want)
    assert found > 0
