"""The reader of ``join_overlap_share``: the program's overlapped joins
over its joins of a state from the card, on planted counters."""

import pytest

from benchmark import program_spans as P
from benchmark.harness import Run, Spec
from bench_support import ROOT


def _request(id_, start, counters):
    return {"name": "qsim/run_detailed", "id": id_, "parent": None,
            "request": id_, "start": start, "end": start + 9.0,
            "counters": counters}


def _read(monkeypatch, records):
    monkeypatch.setattr(P, "program_records", lambda: records)
    run = Run(requests=[(10.0, 20.0, 20.0), (20.0, 30.0, 30.0)])
    return Spec(ROOT).reader("join_overlap_share.amps").read(run)


@pytest.mark.parametrize("counters, want", [
    # every join's output ready while the card ran
    ([{"state_joins": 1, "state_join_overlapped": 1}] * 2, 1.0),
    # one of two joins waited for the card first
    ([{"state_joins": 1, "state_join_overlapped": 1},
      {"state_joins": 1}], 0.5),
    # requests recorded, no join from a card (a CPU run, an older program)
    ([{"plan_cache_hit": 1}] * 2, None),
])
def test_join_overlap_share_on_planted_counters(monkeypatch, counters,
                                                want):
    records = [_request(i + 1, 10.5 + 10 * i, c)
               for i, c in enumerate(counters)]
    assert _read(monkeypatch, records) == want


def test_join_overlap_share_is_silent_without_a_request(monkeypatch):
    assert _read(monkeypatch, []) is None
    assert _read(monkeypatch, None) is None
