"""The reader of ``mono_step_share``: the program's in-place mono steps
over its mono and mat steps, on planted counters."""

import pytest

from benchmark import program_spans as P
from benchmark.harness import Run, Spec
from bench_support import ROOT


def _request(id_, start, counters):
    return {"name": "qsim/sample", "id": id_, "parent": None,
            "request": id_, "start": start, "end": start + 9.0,
            "counters": counters}


def _read(monkeypatch, records):
    monkeypatch.setattr(P, "program_records", lambda: records)
    run = Run(requests=[(10.0, 20.0, 20.0), (20.0, 30.0, 30.0)])
    return Spec(ROOT).reader("mono_step_share.shots").read(run)


@pytest.mark.parametrize("counters, want", [
    # the n = 30 plan's monos as mono steps, two requests
    ([{"inplace_mono_steps": 548, "inplace_mat_steps": 144}] * 2,
     548 / 692),
    # monos lowered as mats: no mono step
    ([{"inplace_mat_steps": 692}] * 2, 0.0),
    # one request of monos alone, one of mats alone
    ([{"inplace_mono_steps": 3}, {"inplace_mat_steps": 1}], 0.75),
    # requests recorded, no in-place step (another engine, an older program)
    ([{"plan_cache_hit": 1}] * 2, None),
])
def test_mono_step_share_on_planted_counters(monkeypatch, counters, want):
    records = [_request(i + 1, 10.5 + 10 * i, c)
               for i, c in enumerate(counters)]
    got = _read(monkeypatch, records)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


def test_mono_step_share_is_silent_without_a_request(monkeypatch):
    assert _read(monkeypatch, []) is None
    assert _read(monkeypatch, None) is None
