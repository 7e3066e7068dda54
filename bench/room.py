"""The benchmark's data and reference at a larger scale than a cell's,
on the CPU alone: how long they take, how much memory, and whether the
reference still agrees with a scan.

    python3 bench/room.py --config bench/configs/ecom9m-sharded4.json \
        --times 10 --seed 1 --requests 200

makes the configuration's data at ``--times`` its entity counts (the
degree and Zipf keys unchanged), builds the reference's store, and
prints one JSON line: the wall time of each, the process's peak resident
memory after each, the triple and term counts, the largest term id's
bits, and the fragment mismatches of ``--requests`` requests against a
scan of the triples (and, to show that the comparison fails a fault,
those of ``control.py``'s storage-order fragments). The requests are the
patterns of the ``anchored`` and ``stress`` mixes' queries, half alone
and half with up to 30 mappings bound from the scan's matches of the
query's first pattern; a quarter at a page drawn from the first four,
the others at page 0.
"""
from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ENTITY_KEYS = ("users", "products", "reviews", "retailers", "genres",
               "cities", "tags")
ORDERS = ((0, 1, 2), (1, 2, 0), (2, 0, 1))


def peak_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


class Scan:
    """Matches by comparing every triple, in the order of the permutation
    the reference's docstring states (SPO, POS, OSP: the first with the
    longest bound prefix)."""

    def __init__(self, triples: np.ndarray) -> None:
        self.cols = [np.ascontiguousarray(triples[:, i]) for i in range(3)]

    def rows(self, pattern, among=None) -> np.ndarray:
        """The rows of the store (or of ``among``) that match, unsorted."""
        cols = self.cols if among is None else [among[:, i]
                                                for i in range(3)]
        keep = None
        for i in range(3):
            tests = [cols[i] == pattern[i]] if pattern[i] >= 0 else [
                cols[i] == cols[j] for j in range(i + 1, 3)
                if pattern[j] == pattern[i]]
            for hit in tests:
                keep = hit if keep is None else keep & hit
        idx = np.arange(len(cols[0])) if keep is None else np.flatnonzero(
            keep)
        return np.stack([c[idx] for c in cols], axis=1)

    @staticmethod
    def ordered(rows: np.ndarray, pattern) -> np.ndarray:
        best, order = -1, ORDERS[0]
        for perm in ORDERS:
            plen = next((k for k, c in enumerate(perm) if pattern[c] < 0),
                        3)
            if plen > best:
                best, order = plen, perm
        return rows[np.lexsort([rows[:, c] for c in order[::-1]])]

    def page(self, pattern, omega, page_no: int, page_size: int):
        """The page's triples, ``cnt`` and ``has_next``: the
        instantiations' matches concatenated, each triple kept where it
        first occurs (read only as far as the page and one row past
        it)."""
        if omega is None:
            insts = [tuple(pattern)]
        else:
            insts = list(dict.fromkeys(
                tuple(int(m[-c - 1]) if c < 0 and m[-c - 1] >= 0 else c
                      for c in pattern) for m in omega.tolist()))
        among = None
        if any(c >= 0 for c in pattern):
            among = self.rows(tuple(c if c >= 0 else -1 - i
                                    for i, c in enumerate(pattern)))
        streams = [self.rows(inst, among) for inst in insts]
        cnt = sum(len(s) for s in streams)
        need = (page_no + 1) * page_size + 1
        seen, data = set(), []
        for inst, stream in zip(insts, streams):
            stream = self.ordered(stream, inst)
            for k in range(0, len(stream), 4096):
                for row in map(tuple, stream[k:k + 4096].tolist()):
                    if row not in seen:
                        seen.add(row)
                        data.append(row)
                if len(data) >= need:
                    break
            if len(data) >= need:
                break
        lo = page_no * page_size
        page = np.asarray(data[lo:lo + page_size], dtype=np.int32)
        return page.reshape(-1, 3), cnt, lo + page_size < len(data)


def requests(scan: Scan, lay, n: int, seed: int):
    from bench import datagen
    rng = np.random.default_rng(seed)
    mixes = [json.loads((ROOT / "bench" / "mixes" / f"{m}.json")
                        .read_text()) for m in ("anchored", "stress")]
    streams = [datagen.client_stream(spec, lay, seed, 1, c)
               for c in range(8) for spec in mixes]
    out, i = [], 0
    while len(out) < n:
        _name, pats = next(streams[i % len(streams)])
        i += 1
        tp = tuple(int(x) for x in pats[rng.integers(len(pats))])
        omega = None
        if len(out) % 2:
            first = scan.rows(tuple(int(x) for x in pats[0]))
            if len(first) == 0:
                continue
            rows = first[rng.integers(len(first), size=30)]
            omega = np.full((30, int(-pats.min())), -1, dtype=np.int32)
            for comp, c in enumerate(pats[0]):
                if c < 0:
                    omega[:, -int(c) - 1] = rows[:, comp]
        out.append((tp, omega, int(rng.integers(4)) if i % 4 == 0 else 0))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--times", type=int, required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--requests", type=int, default=200)
    args = ap.parse_args()
    sys.path[0] = str(ROOT)
    from bench import check, control, datagen, reference
    scale = dict(json.loads(Path(args.config).read_text())["dataset"]
                 ["scale"])
    for k in ENTITY_KEYS:
        scale[k] = int(scale[k]) * args.times
    out = dict(config=args.config, times=args.times, seed=args.seed)
    t = time.perf_counter()
    triples, lay = datagen.generate(scale, args.seed)
    out.update(generate_s=time.perf_counter() - t,
               generate_peak_gib=peak_gib(), triples=int(len(triples)),
               terms=lay.num_terms,
               id_bits=int(lay.num_terms - 1).bit_length())
    t = time.perf_counter()
    ref = reference.ReferenceStore(triples)
    out.update(reference_s=time.perf_counter() - t,
               reference_peak_gib=peak_gib())
    t = time.perf_counter()
    scan = Scan(triples)
    served = [(tp, omega, page, False) + scan.page(tp, omega, page, 100)
              for tp, omega, page in requests(scan, lay, args.requests,
                                              args.seed)]
    out.update(scan_s=time.perf_counter() - t, requests=len(served),
               with_mappings=sum(s[1] is not None for s in served),
               nonempty_pages=sum(len(s[4]) > 0 for s in served))
    t = time.perf_counter()
    out.update(fragment_mismatches=check.fragment_mismatches(
        check.Answers(ref, 100), served), check_s=time.perf_counter() - t,
        control_mismatches=check.fragment_mismatches(check.Answers(
            ref, 100, control.control_fragment), served),
        peak_gib=peak_gib())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
