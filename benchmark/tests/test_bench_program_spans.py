"""The readers of the program's own spans and counters: the window, self
time and sums on a hand-made span list, and every new metric reported by
a traced CPU run of each cell."""

import os

import pytest

from benchmark import program_spans as P
from benchmark.harness import Run, Spec, run_cell
from benchmark.roofline import KernelTable
from benchmark.tracing import TraceView
from bench_support import ROOT, small_copy

MM = "void (anonymous namespace)::mm_high_kernel<512, true>(float const*)"
CARD_COPIES = {"d2h_ms.amps", "d2h_gbps.amps"}


def _rec(name, id_, parent, request, start, end, counters=None):
    r = {"name": name, "id": id_, "parent": parent, "request": request,
         "start": start, "end": end}
    if counters is not None:
        r["counters"] = counters
    return r


def _records():
    """Two requests at 10-20 and 20-30 s, one left over from before the
    window (5-6 s).  The first plans for 6 s, 2 of them fusing and 1.5
    uploading tables (overlapping children: 3 covered)."""
    return [
        _rec("qsim/sample", 1, None, 1, 5.0, 6.0,
             {"plan_cache_miss": 9}),
        _rec("qsim/fuse", 3, 2, 2, 11.0, 13.0),
        _rec("qsim/tables", 4, 2, 2, 12.5, 14.0),
        _rec("qsim/plan", 2, 5, 5, 10.5, 16.5),
        _rec("qsim/sample", 5, None, 5, 10.1, 19.9,
             {"plan_cache_miss": 2, "table_h2d_bytes": 3_000_000,
              "launches/run_split_block/mat_high": 10,
              "launches/run_xswap": 4}),
        _rec("qsim/tables", 7, 6, 6, 21.0, 22.0),
        _rec("qsim/sample", 6, None, 6, 20.1, 29.9,
             {"plan_cache_hit": 1, "table_h2d_bytes": 1_000_000,
              "launches/run_split_block/mat_high": 10}),
    ]


def _run():
    return Run(requests=[(10.0, 20.0, 20.0), (20.0, 30.0, 30.0)])


def test_window_self_time_and_sums():
    recs = _records()
    run = _run()
    inside = P.in_window(run, recs)
    assert [r["id"] for r in inside] == [3, 4, 2, 5, 7, 6]
    plan = recs[3]
    # 6 s less the union of 11-13 and 12.5-14
    assert P.self_s(plan, recs) == pytest.approx(3.0)
    # a request: (3 s of the plan's own) / 2 requests
    assert P.ms_per_request(run, "qsim/plan", own=True,
                            records=recs) == pytest.approx(1500.0)
    assert P.ms_per_request(run, "qsim/tables",
                            records=recs) == pytest.approx(1250.0)
    assert P.ms_per_request(run, "qsim/join", records=recs) is None
    totals = P.counter_totals(run, recs)
    assert totals == {"plan_cache_miss": 2, "plan_cache_hit": 1,
                      "table_h2d_bytes": 4_000_000,
                      "launches/run_split_block/mat_high": 20,
                      "launches/run_xswap": 4}
    assert P.counter_totals(Run(requests=[(40.0, 50.0, 50.0)]), recs) is None


def test_readers_on_the_span_list(monkeypatch):
    monkeypatch.setattr(P, "program_records", _records)
    spec, run = Spec(ROOT), _run()

    def read(name):
        return spec.reader(name).read(run)

    assert read("plan_build_ms.shots") == pytest.approx(1500.0)
    assert read("fuse_ms.shots") == pytest.approx(1000.0)
    assert read("table_upload_mb.shots") == pytest.approx(2.0)
    assert read("plan_cache_hit_share.shots") == pytest.approx(1 / 3)
    assert read("hand_launches_per_circuit.shots") == pytest.approx(12.0)
    assert read("d2h_ms.amps") is None and read("join_ms.amps") is None
    assert read("d2h_gbps.amps") is None


def test_d2h_rate_is_the_bytes_over_the_copies_time(monkeypatch):
    """Two requests, each copying 2 GB from the card in two 20 ms spans:
    50 GB/s."""
    def records():
        out = []
        for i, t in enumerate((10.0, 20.0)):
            req = 10 * (i + 1)
            out += [_rec("qsim/d2h", req + 1, req, req, t + 1.0, t + 1.02),
                    _rec("qsim/d2h", req + 2, req, req, t + 2.0, t + 2.02),
                    _rec("qsim/run_detailed", req, None, req, t + 0.1,
                         t + 9.9, {"state_d2h_bytes": 2_000_000_000})]
        return out

    monkeypatch.setattr(P, "program_records", records)
    spec = Spec(ROOT)
    assert spec.reader("d2h_ms.amps").read(_run()) == pytest.approx(40.0)
    assert spec.reader("d2h_gbps.amps").read(_run()) == pytest.approx(50.0)


def test_without_the_programs_telemetry_every_reader_is_silent(
        monkeypatch):
    """An older program keeps no spans: every new reader returns None."""
    monkeypatch.setattr(P, "program_records", lambda: None)
    spec = Spec(ROOT)
    for m in spec.bench["per_layer"]:
        if m["source"] in ("program_span", "program_counter"):
            assert spec.reader(m["name"]).read(_run()) is None, m["name"]


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_program_spans_are_no_requests_of_the_trace():
    events = [_ev("user_annotation", "sample#0", 0.0, 100.0),
              _ev("user_annotation", "qsim/sample", 1.0, 98.0),
              _ev("user_annotation", "qsim/plan", 2.0, 10.0),
              _ev("kernel", MM, 20.0, 20.0)]
    t = TraceView(events, {"mm_high_kernel"},
                  KernelTable(os.path.join(ROOT, "benchmark", "kernels")), 28)
    assert [r[0] for r in t.requests] == ["sample"]


@pytest.mark.parametrize("cell", ["grover2445-n28-mxu.amps",
                                  "grover2445-n30-inplace.shots"])
def test_a_traced_cpu_run_reports_every_new_metric(tmp_path, cell):
    root = small_copy(tmp_path)
    spec = Spec(root)
    want = {m["name"] for m, _ in spec.metrics(cell, traced=True)
            if m["source"] in ("program_span", "program_counter")}
    assert want
    # a CPU state is never copied from a card: its copy metrics are silent
    want -= CARD_COPIES
    # a seed of this test alone: the port's plan caches live as long as the
    # process, and a circuit another test planned would skip fusion here
    result, _ = run_cell(spec, cell, 2147483693, 0.0, True, "cpu", 0.0,
                         log=lambda *a: None)
    assert result["correct"]
    assert want <= set(result["metrics"])
    assert not CARD_COPIES & set(result["metrics"])
    got = {k: v["value"] for k, v in result["metrics"].items()}
    share = "plan_cache_hit_share." + cell.split(".")[1]
    assert got[share] == (1.0 if cell.endswith("amps") else 0.0)
