"""The readers of the store's counters on a made-up run: kept rows copied
back per request (``rows_back_per_request``) and the seconds of the
store's build (``store_build_s``, from the port's build record), each
the number worked out by hand, and None where there is nothing to read."""
from __future__ import annotations

import builtins
from types import SimpleNamespace

import pytest

from bench import harness
from repro_torch.core import metrics


def made_up(**kw):
    run = dict(cuda={"launches": 12, "live_slots": 40, "rows_back": 900},
               server_requests=300)
    run.update(kw)
    return SimpleNamespace(**run)


@pytest.fixture
def reader():
    return lambda name: harness.readers([name])[name].read


@pytest.fixture
def record(monkeypatch):
    rec = metrics.StoreBuild(
        host={"dedup": 1.5, "pos": 2.0, "osp": 2.5},
        device={"spo": 1.0, "pos": 1.25, "osp": 0.75, "copy": 0.5},
        widths={"spo": (25, 4, 25), "pos": (4, 25, 25),
                "osp": (25, 25, 4)})
    monkeypatch.setattr(metrics, "STORE_BUILD", rec)
    return rec


def test_rows_back_per_request(reader):
    assert reader("rows_back_per_request")(made_up()) == 3.0


@pytest.mark.parametrize("run", [
    made_up(server_requests=0),
    made_up(cuda={"launches": 12, "live_slots": 40}),   # a port without it
], ids=["no requests", "no counter"])
def test_rows_back_nothing_to_read_gives_none(reader, run):
    assert reader("rows_back_per_request")(run) is None


def test_store_build_sums_host_and_device_and_logs_the_split(
        reader, record, capsys):
    assert reader("store_build_s")(made_up()) == pytest.approx(9.5)
    log = capsys.readouterr().err
    assert "host 6.000 s (dedup 1.500, pos 2.000, osp 2.500)" in log
    assert "device 3.500 s (spo 1.000" in log
    assert "spo 25+4+25, pos 4+25+25, osp 25+25+4" in log


def test_store_build_of_a_host_store_alone(reader, record):
    record.device = {}
    assert reader("store_build_s")(made_up()) == pytest.approx(6.0)


def test_store_build_nothing_to_read_gives_none(reader, record,
                                                monkeypatch):
    record.host = {}
    assert reader("store_build_s")(made_up()) is None
    real = builtins.__import__

    def no_record(name, *args, **kw):
        if name == "repro_torch.core.metrics":
            raise ImportError(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_record)
    assert reader("store_build_s")(made_up()) is None


def test_a_real_build_fills_the_record(reader):
    import numpy as np

    from repro_torch.core import TripleStore
    from repro_torch.core.federation import FederatedStore
    rng = np.random.default_rng(0)
    store = TripleStore(rng.integers(0, 50, (300, 3)).astype(np.int32))
    FederatedStore.build(store.triples, 2, device="cpu",
                         layout=store.layout)
    assert metrics.STORE_BUILD.widths["spo"] == (21, 21, 21)
    got = reader("store_build_s")(made_up())
    assert got == pytest.approx(sum(metrics.STORE_BUILD.host.values())
                                + sum(metrics.STORE_BUILD.device.values()))
