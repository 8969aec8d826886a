"""The metric arithmetic on synthetic traces, and the least-work counts."""

import os

import pytest

from benchmark import roofline as R
from benchmark.harness import Run, Spec
from benchmark.tracing import TraceView, hand_kernels, merged, union_us
from bench_support import ROOT, PORT

HERE = os.path.join(ROOT, "benchmark")
TABLE = R.KernelTable(os.path.join(HERE, "kernels"))
MM = "void (anonymous namespace)::mm_high_kernel<512, true>(float const*)"
MAT = "void (anonymous namespace)::mat_high_halves_kernel<true>(HalvesMap)"
SWAP = "void (anonymous namespace)::swap_rows_kernel(float4*, long long, int)"
TORCH = "void at::native::vectorized_elementwise_kernel<4, float>(int, float)"


def _reader(name):
    """The reader the harness finds for ``name``."""
    return Spec(ROOT).reader(name).read


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace():
    """Two requests of 100 us each; hand launches at 20-40 and 50-70 in the
    first, 130-170 in the second; a torch kernel at 80-85; a copy at
    185-195; a device event outside the window is left out."""
    events = [
        _ev("user_annotation", "sample#0", 0.0, 100.0),
        _ev("user_annotation", "sample#1", 100.0, 100.0),
        _ev("user_annotation", "unrelated", 0.0, 500.0),
        _ev("cpu_op", "aten::copy_", 10.0, 5.0),
        _ev("kernel", MM, 20.0, 20.0),
        _ev("kernel", MM, 50.0, 20.0),
        _ev("kernel", TORCH, 80.0, 5.0),
        _ev("kernel", MM, 130.0, 40.0),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 185.0, 10.0),
        _ev("gpu_user_annotation", "sample#1", 100.0, 100.0),
        _ev("kernel", MM, 400.0, 10.0),
    ]
    return TraceView(events, {"mm_high_kernel"}, TABLE, 28)


def test_union_and_merge():
    assert union_us([]) == 0.0
    assert union_us([(0, 10), (5, 15), (20, 30)]) == 25.0
    assert union_us([(20, 30), (0, 10), (2, 3)]) == 20.0
    assert merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def test_window_busy_and_idle():
    t = _trace()
    assert t.window_s == pytest.approx(200e-6)
    # 20 + 20 + 5 + 40 + 10 us busy
    assert t.busy_s() == pytest.approx(95e-6)
    assert t.idle_share() == pytest.approx(1 - 95 / 200)
    run = Run(trace=t, requests=[0, 1])
    assert _reader("idle_share.shots")(run) == pytest.approx(0.525)
    assert _reader("idle_share.amps")(run) == pytest.approx(0.525)


def test_busy_time_is_the_mean_over_the_cards():
    """Two cards: busy where either card runs counts once a card, and the
    mean of the cards' unions is the run's busy time."""
    events = [_ev("user_annotation", "run_many#0", 0.0, 100.0)]
    for card, spans in ((0, [(0, 40), (20, 60)]), (1, [(10, 30)])):
        for ts, end in spans:
            ev = _ev("kernel", MM, float(ts), float(end - ts))
            ev["args"] = {"device": card}
            events.append(ev)
    t = TraceView(events, {"mm_high_kernel"}, TABLE, 28, chips=2)
    assert t.busy_s() == pytest.approx((60e-6 + 20e-6) / 2)
    assert t.idle_share() == pytest.approx(0.6)
    assert [r[0] for r in t.requests] == ["run_many"]


def test_a_reader_serves_every_split_of_its_quantity():
    """``idle_share.amps`` and ``idle_share.shots`` are read by
    ``metrics/idle_share.py``; a name with a file of its own keeps it; a
    name with neither is refused."""
    spec = Spec(ROOT)
    assert spec.reader("idle_share.amps") is not None
    assert spec.reader("idle_share.later").__file__.endswith(
        os.path.join("metrics", "idle_share.py"))
    assert spec.reader("setup_s").__file__.endswith("setup_s.py")
    with pytest.raises(ValueError):
        spec.reader("no_such_metric.amps")


def test_launches_lead_and_tail():
    t = _trace()
    run = Run(trace=t, requests=[0, 1])
    # 4 kernels in the window (3 hand, 1 torch) over 2 requests
    assert _reader("launches_per_circuit.shots")(run) == 2.0
    # first hand launch at 20 and 130: leads 20 and 30 us
    assert _reader("plan_ms.shots")(run) == pytest.approx(25e-3)
    # last hand launch ends at 70 and 170: tails 30 and 30 us
    assert _reader("sample_ms.shots")(run) == pytest.approx(30e-3)
    assert _reader("restore_ms.amps")(run) == pytest.approx(30e-3)


def test_roofline_share_of_hand_launches():
    t = _trace()
    least = R.matmul_least_s(28, 512, "high")
    assert least == pytest.approx(18 * 2**28 * 512 / 989e12)
    want = 100 * 3 * least / 80e-6
    assert t.kernel_roofline_pct() == pytest.approx(want)
    assert _reader("kernel_roofline.shots")(Run(trace=t)) == pytest.approx(
        want)
    assert t.unmapped() == set()


def test_metrics_are_silent_without_a_trace_or_a_hand_kernel():
    run = Run(trace=None, requests=[0])
    for name in ("idle_share.amps", "kernel_roofline.shots",
                 "plan_ms.shots", "sample_ms.shots", "restore_ms.amps",
                 "launches_per_circuit.amps"):
        assert _reader(name)(run) is None
    events = [_ev("user_annotation", "run_detailed#0", 0.0, 10.0),
              _ev("kernel", TORCH, 1.0, 2.0)]
    t = TraceView(events, {"mm_high_kernel"}, TABLE, 20)
    assert t.kernel_roofline_pct() is None
    assert t.lead_ms() is None and t.tail_ms() is None


def test_breakdown_names_ops_and_gaps():
    b = _trace().breakdown()
    ops = dict(b["device_ops"])
    assert ops["mm_high_kernel"] == pytest.approx(80e-6)
    assert ops["vectorized_elementwise_kernel"] == pytest.approx(5e-6)
    assert ops["Memcpy DtoH (Device -> Pinned)"] == pytest.approx(10e-6)
    gaps = b["idle_gaps"]
    assert gaps[0] == ["sample#1 before its first launch",
                       pytest.approx(30e-6)]
    labels = {g[0] for g in gaps}
    assert "sample#0 before its first launch" in labels
    assert "sample#0 between its launches" in labels
    assert "sample#1 after its last launch" in labels
    assert sum(g[1] for g in gaps) == pytest.approx(105e-6)


def test_least_times_per_kernel_kind():
    n = 30
    bytes_all = 16 * 2**n / 3.35e12
    assert TABLE.least_s(MAT, n) == (pytest.approx(bytes_all), True)
    assert TABLE.least_s(SWAP, n)[0] == pytest.approx(bytes_all / 2)
    dflt = MM.replace("true", "false")
    assert TABLE.least_s(dflt, 28)[0] == pytest.approx(
        max(6 * 2**28 * 512 / 989e12, 16 * 2**28 / 3.35e12))
    assert R.matmul_least_s(22, 256, "highest") == pytest.approx(
        6 * 2**22 * 256 / 67e12)
    assert TABLE.least_s("void new_kernel(float*)", n) == (
        pytest.approx(bytes_all), False)


def test_kernel_names_parse():
    assert R.parse_kernel(MM) == ("mm_high_kernel", ["512", "true"])
    assert R.parse_kernel(SWAP) == ("swap_rows_kernel", [])


def test_every_hand_kernel_has_a_table_entry():
    hand = hand_kernels(os.path.join(ROOT, PORT, "csrc"))
    assert {"mm_high_kernel", "mat_high_halves_kernel", "swap_rows_kernel",
            "relayout_inplace_kernel", "row_local_kernel"} <= hand
    probes = {"grid_copy_kernel", "stream_copy_kernel", "hbm_direct_kernel"}
    assert hand - probes <= set(TABLE.entries)
