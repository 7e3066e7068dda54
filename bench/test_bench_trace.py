"""The readers of the port's own spans (``repro_torch.core.trace``) on
hand-built span sets: each gives the number worked out by hand, ignores
the spans that ended outside ``[profile_t0, profile_t1]``, and gives
None with no spans, with dropped spans, or against a port that records
none."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from bench import harness
from repro_torch.core import metrics
from repro_torch.core.trace import Span, SpanRing

MS = 1_000_000                    # nanoseconds
T = 10 * 10**9                    # the window opens at 10 s
RUN = SimpleNamespace(profile_t0=10.0, profile_t1=20.0)


def phases(flush_id, t, **ms):
    """Phase spans of one flush, one after another from ``t``, each
    followed by 0.5 ms that no phase covers."""
    out = []
    for i, (name, length) in enumerate(ms.items()):
        out.append(Span(name, flush_id * 100 + i, flush_id, 0, t,
                        t + length * MS))
        t += length * MS + MS // 2
    return out


def inside():
    """Two requests (one batched twice over), a timer flush 2 ms late,
    and a full flush, all ended in the window."""
    return [
        Span("request", 1, 0, 100, T, T + 10 * MS),
        Span("front", 2, 1, 100, T + MS, T + 5 * MS),       # edge 6 ms
        Span("wait", 3, 2, 100, T + MS, T + 3 * MS),        # 2 ms
        Span("request", 4, 0, 101, T + 2 * MS, T + 6 * MS),
        Span("front", 5, 4, 101, T + 2 * MS, T + 4 * MS),   # edge 2 ms
        Span("wait", 6, 5, 101, T + 2 * MS, T + 6 * MS),    # 4 ms
        Span("flush", 7, 0, (100, 101), T + 3 * MS, T + 13 * MS,
             "timer", T + MS),
        *phases(7, T + 3 * MS, prep=2, copy_in=1, collect=1, order=3,
                serve=0.5),
        Span("flush", 8, 0, (102,), T + 20 * MS, T + 26 * MS, "full"),
        *phases(8, T + 20 * MS, prep=1, serve=4),
    ]


def outside():
    """Spans that ended before or after the window."""
    late = 25 * 10**9
    return [
        Span("request", 50, 0, 200, T - 9 * MS, T - MS),
        Span("wait", 51, 0, 201, T - 9 * MS, T - 2 * MS),
        Span("flush", 52, 0, (201,), late, late + 90 * MS, "timer",
             late - 50 * MS),
        *phases(52, late, prep=40, serve=40),
    ]


# flushes of 10 and 6 ms; phases 7.5 + 5 ms (prep 3, copy_in 1,
# collect 1, order 3, serve 4.5); waits 2 and 4 ms; edges 6 and 2 ms
EXPECTED = {
    "edge_self_ms": 4.0,
    "queue_wait_ms": 3.0,
    "flush_late_ms": 2.0,
    "flush_ms": 8.0,
    "select_prep_ms": 1.5,
    "copy_in_ms": 0.5,
    "collect_ms": 0.5,
    "stream_order_ms": 1.5,
    "serve_ms": 2.25,
    "flush_unattributed_pct": 100.0 * (16 - 12.5) / 16,
}


def ring(spans, capacity=1024):
    r = SpanRing(capacity)
    for s in spans:
        r.add(s)
    return r


@pytest.fixture
def recorder(monkeypatch):
    def use(r):
        monkeypatch.setattr(metrics, "TRACE", r)
    return use


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_on_a_hand_built_span_set(name, recorder):
    recorder(ring(outside()[:2] + inside() + outside()[2:]))
    read = harness.readers([name])[name].read
    assert read(RUN) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_nothing_to_read_gives_none(name, recorder, monkeypatch):
    read = harness.readers([name])[name].read
    recorder(ring([]))
    assert read(RUN) is None
    recorder(ring(outside()))                  # none ended in the window
    assert read(RUN) is None
    full = ring(inside(), capacity=len(inside()) - 1)
    assert full.dropped() == 1
    recorder(full)
    assert read(RUN) is None
    monkeypatch.delattr(metrics, "TRACE")      # a port without spans
    assert read(RUN) is None


def test_the_late_flush_needs_a_timer_flush(recorder):
    recorder(ring([s for s in inside() if s.cause != "timer"]))
    assert harness.readers(["flush_late_ms"])["flush_late_ms"].read(
        RUN) is None


def test_the_split_adds_up_to_the_flush():
    """The five phases and the unattributed share make up ``flush_ms``."""
    parts = sum(EXPECTED[n] for n in ("select_prep_ms", "copy_in_ms",
                                      "collect_ms", "stream_order_ms",
                                      "serve_ms"))
    assert parts + EXPECTED["flush_ms"] * EXPECTED[
        "flush_unattributed_pct"] / 100 == pytest.approx(
        EXPECTED["flush_ms"])
