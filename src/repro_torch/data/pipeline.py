"""brTPF-backed training data plane (the port's copy of
``repro.data.pipeline``, over the port's own ``core``).

Data curation is expressed as BGP queries over a *metadata triple store*
(doc -> hasDomain / hasQuality / hasLang triples). The pipeline executes
the selection through the actual brTPF client, so example selection
inherits the paper's network-load reduction: on a sharded corpus the
bindings (candidate doc ids) travel to the metadata store instead of the
full posting lists traveling to the trainer.

The token payloads are synthetic, drawn from the corpus seed; the
selection path is the real integration point. The server runs the numpy
backend, as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np

from ..core import (BGP, BrTPFClient, BrTPFServer, ServerConfig,
                    TermDictionary, TripleStore, parse_bgp)


@dataclasses.dataclass
class SyntheticCorpus:
    """Documents with metadata triples + deterministic synthetic tokens."""

    dictionary: TermDictionary
    store: TripleStore
    doc_ids: List[int]                  # term ids of doc entities
    doc_lengths: Dict[int, int]
    vocab_size: int
    seed: int = 0

    @classmethod
    def generate(cls, num_docs: int = 200, vocab_size: int = 1024,
                 seed: int = 0) -> "SyntheticCorpus":
        rng = np.random.default_rng(seed)
        d = TermDictionary()
        HAS_DOMAIN = d.intern("hasDomain")
        HAS_QUALITY = d.intern("hasQuality")
        HAS_LANG = d.intern("hasLang")
        TYPE = d.intern("type")
        DOC = d.intern("Document")
        domains = [d.intern(x) for x in
                   ("web", "code", "science", "news", "books")]
        quals = [d.intern(f"q{i}") for i in range(5)]
        langs = [d.intern(x) for x in ("en", "de", "es")]
        rows, doc_ids, lengths = [], [], {}
        for i in range(num_docs):
            doc = d.intern(f"doc{i}")
            doc_ids.append(doc)
            rows.append((doc, TYPE, DOC))
            rows.append((doc, HAS_DOMAIN,
                         domains[int(rng.integers(len(domains)))]))
            rows.append((doc, HAS_QUALITY,
                         quals[int(rng.zipf(1.5) - 1) % 5]))
            rows.append((doc, HAS_LANG,
                         langs[int(rng.integers(len(langs)))]))
            lengths[doc] = int(rng.integers(64, 512))
        return cls(d, TripleStore(np.asarray(rows, np.int32)), doc_ids,
                   lengths, vocab_size, seed)

    def tokens_for(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + doc_id)
        return rng.integers(
            1, self.vocab_size,
            size=self.doc_lengths.get(doc_id, 128)).astype(np.int32)


@dataclasses.dataclass
class PipelineStats:
    num_requests: int = 0
    data_received: int = 0
    selected_docs: int = 0


class BrTPFDataPipeline:
    """Select documents with a BGP via brTPF; stream packed LM batches."""

    def __init__(self, corpus: SyntheticCorpus, selection_query: str,
                 batch_size: int, seq_len: int,
                 max_mpr: int = 30, seed: int = 0) -> None:
        self.corpus = corpus
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self.server = BrTPFServer(corpus.store,
                                  ServerConfig(max_mpr=max_mpr))
        self.bgp = parse_bgp(selection_query, corpus.dictionary)
        self.stats = PipelineStats()
        self._selected = self._select()

    def _select(self) -> List[int]:
        client = BrTPFClient(self.server)
        res = client.execute(self.bgp)
        self.stats.num_requests = res.num_requests
        self.stats.data_received = res.data_received
        # by convention the first variable of the query binds the doc
        docs = sorted({int(row[0]) for row in res.solutions})
        self.stats.selected_docs = len(docs)
        if not docs:
            raise ValueError("selection query matched no documents")
        return docs

    @property
    def selected_docs(self) -> List[int]:
        return list(self._selected)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.batches()

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite stream of packed {tokens, targets} batches."""
        rng = np.random.default_rng(self.seed)
        buf = np.empty((0,), np.int32)
        need = self.batch_size * (self.seq_len + 1)
        while True:
            while buf.shape[0] < need:
                doc = self._selected[int(rng.integers(
                    len(self._selected)))]
                buf = np.concatenate([buf, self.corpus.tokens_for(doc)])
            chunk = buf[:need].reshape(self.batch_size, self.seq_len + 1)
            buf = buf[need:]
            yield {"tokens": chunk[:, :-1], "targets": chunk[:, 1:]}
