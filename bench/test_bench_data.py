"""The benchmark's data and reference on the CPU: the bulk generator
against the port's ``data/watdiv.py`` distributions, the query streams,
and the NumPy reference against the port's numpy backend, fragment for
fragment, and against its brTPF client's solutions."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from bench import reference, datagen

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
