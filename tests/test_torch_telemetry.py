"""The port's spans and counters (``telemetry.py``) on the CPU, n <= 14:
a request's spans exist only while the profiler records, nest under one
facade span that carries the request's counters, land in the chrome trace
under names the benchmark's request pattern never matches, and the
counters count cache lookups, table bytes and every wrapper's launches."""

import importlib
import inspect
import json
import pkgutil
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import kernels, parallel, telemetry
from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
from gpu_quantum_simulator_tpu_torch.engine.simulator import _fuse_pipeline
from gpu_quantum_simulator_tpu_torch.ir.circuit import Circuit
from gpu_quantum_simulator_tpu_torch.ops import pallas_kernels

N = 12
REQUEST_PATTERN = re.compile(r"^[\w.-]+#\d+$")   # benchmark/tracing.py SPAN


def _circuit(seed, n=N):
    """A circuit no other test plans: its rz angles come from ``seed``."""
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    for q in range(n):
        c.append("h", q)
    for layer in range(6):
        for q in range(layer % 2, n - 1, 2):
            c.append("cx", q, q + 1)
        for q in range(n):
            c.append("rz", q, params=(float(rng.uniform(-3, 3)),))
    return c


def _sim(**kw):
    return T.Simulator(T.SimulatorConfig(**kw), device="cpu")


def _inplace():
    return _sim(strategy="prefetch", prefetch_inplace=True, precision="high")


def _traced(fn):
    """Run ``fn`` under a CPU profile; (its span records, the profile)."""
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return telemetry.spans(), prof


def _requests(spans):
    return [s for s in spans if "counters" in s]


def test_without_a_profiler_a_run_records_no_span():
    telemetry.reset()
    assert telemetry.span("qsim/plan") is telemetry.span("qsim/fuse")
    _sim(precision="high").run_detailed(_circuit(1))
    _inplace().run_device_halves(_circuit(2))
    assert telemetry.spans() == []


# each entry point's call on a circuit: mxu ``run_detailed``, the in-place
# ``run_device_halves`` through ``strategy="auto"`` (whose resolved
# simulator enters the facade again) and ``sample`` (which runs the circuit
# through ``run``)
ENTRIES = {
    "run_detailed": lambda c: _sim(precision="high").run_detailed(c),
    "run_device_halves": lambda c: _sim(
        strategy="auto", prefetch_inplace=True,
        precision="high").run_device_halves(c),
    "sample": lambda c: _sim(precision="high").sample(c, 64),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_one_facade_span_a_request(entry):
    """One facade span a call, and every span of the call carries its
    request id."""
    c = _circuit(10 + len(entry))
    spans, _ = _traced(lambda: ENTRIES[entry](c))
    (req,) = _requests(spans)
    assert req["name"] == "qsim/" + entry
    assert req["parent"] is None and req["request"] == req["id"]
    assert len(spans) > 1
    assert all(s["request"] == req["id"] for s in spans)
    assert all(req["start"] <= s["start"] <= s["end"] <= req["end"]
               for s in spans)


def test_fuse_nests_in_plan_and_the_trace_holds_the_spans(tmp_path):
    """A planning miss: ``qsim/fuse`` is a child of ``qsim/plan``, the
    tables go up in ``qsim/tables``; the chrome trace holds the same
    ``qsim/*`` names as user annotations, none of them a request name of
    the benchmark's harness."""
    spans, prof = _traced(lambda: _inplace().run_device_halves(
        _circuit(3)))
    by_id = {s["id"]: s for s in spans}
    fuse = [s for s in spans if s["name"] == "qsim/fuse"]
    assert fuse and all(by_id[s["parent"]]["name"] == "qsim/plan"
                        for s in fuse)
    assert any(s["name"] == "qsim/tables" for s in spans)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    mine = {s["name"] for s in spans}
    assert mine <= names
    qsim = {n for n in names if n.startswith("qsim/")}
    assert qsim == mine
    assert not any(REQUEST_PATTERN.match(n) for n in qsim)


def test_a_repeated_circuit_misses_then_hits():
    sim = _sim(precision="high")
    c = _circuit(4)
    before = telemetry.counters()
    sim.run_detailed(c)
    first = telemetry.counters()
    sim.run_detailed(c)
    second = telemetry.counters()

    def delta(a, b, k):
        return b.get(k, 0) - a.get(k, 0)

    assert delta(before, first, "plan_cache_hit") == 0
    assert delta(before, first, "plan_cache_miss") >= 1
    assert delta(first, second, "plan_cache_hit") == 1
    assert delta(first, second, "plan_cache_miss") == 0


def test_request_counters_are_the_change_over_the_request():
    """The facade span's ``counters``: a planned request's miss and table
    bytes, a repeat's hit and no bytes."""
    sim = _inplace()
    c = _circuit(5)
    spans, _ = _traced(lambda: (sim.run_device_halves(c),
                                sim.run_device_halves(c)))
    first, second = _requests(spans)
    assert first["counters"]["plan_cache_miss"] == 2   # run and program
    assert "plan_cache_hit" not in first["counters"]
    assert second["counters"]["plan_cache_hit"] == 1
    assert (second["counters"]["table_h2d_bytes"]
            == first["counters"]["table_h2d_bytes"] > 0)


def test_table_bytes_are_the_parts_nbytes():
    """An in-place run hands each part's compact factors to the device
    once a call: ``table_h2d_bytes`` grows by their ``nbytes``."""
    c = _circuit(6)
    ops = _fuse_pipeline(c, PF.LANE_QUBITS, max_high=2, window=8)
    prog = PF.build_prefetch_program(ops, N, precision="high", device="cpu",
                                     inplace=True)
    parts = prog._chain._parts
    want = sum(t.nbytes for scal, tabs in parts
               if any(row[0] for row in scal) for t in tabs)
    assert want > 0
    before = telemetry.counters().get("table_h2d_bytes", 0)
    prog.run_parts(*PF.initial_halves(N, "cpu"))
    assert telemetry.counters()["table_h2d_bytes"] - before == want


def test_a_host_state_is_joined_and_never_counted_as_a_copy():
    """A CPU state goes to the host without a copy from a card: the join
    is timed, ``qsim/d2h`` and ``state_d2h_bytes`` stay silent (on a card
    each part's pinned copy is one ``qsim/d2h``), on one device and over
    a mesh of shards."""
    from gpu_quantum_simulator_tpu_torch.ops.apply import initial_state_parts
    from gpu_quantum_simulator_tpu_torch.parallel import sharded

    spans, _ = _traced(lambda: _sim(precision="high").run_detailed(
        _circuit(7)))
    names = [s["name"] for s in spans]
    assert names.count("qsim/join") == 1 and "qsim/d2h" not in names
    re, im = initial_state_parts(N, device="cpu")
    shards = (list(re.chunk(4)), list(im.chunk(4)))
    spans, _ = _traced(lambda: sharded.join_shards(*shards))
    assert [s["name"] for s in spans] == ["qsim/join"]
    assert "state_d2h_bytes" not in telemetry.counters()


def test_upload_counts_its_bytes():
    from gpu_quantum_simulator_tpu_torch.ops.apply import upload

    before = telemetry.counters().get("table_h2d_bytes", 0)
    upload(np.zeros((3, 5), np.float32), torch.device("cpu"))
    assert telemetry.counters()["table_h2d_bytes"] - before == 60


def _counting_wrappers():
    """Every function of kernels/, ops/pallas_kernels.py and parallel/ that
    has a ``launches`` attribute."""
    mods = [pallas_kernels]
    for pkg in (kernels, parallel):
        mods += [importlib.import_module(f"{pkg.__name__}.{m.name}")
                 for m in pkgutil.iter_modules(pkg.__path__)]
    return {fn for mod in mods for _, fn in inspect.getmembers(mod)
            if callable(fn) and hasattr(fn, "launches")}


def test_one_enumeration_holds_every_launch_counter():
    """Every wrapper with a ``launches`` attribute registered itself
    (``@telemetry.counted``)."""
    found = _counting_wrappers()
    listed = {fn for fn, _ in telemetry.launch_counts()}
    assert found and found <= listed
    names = telemetry.counters()
    for key in ("launches/mm_step_high", "launches/mm_step_default",
                "launches/kh0_chain/default", "launches/gswap"):
        assert key in names


def test_reset_zeroes_every_launch_counter():
    from gpu_quantum_simulator_tpu_torch import profiling
    from gpu_quantum_simulator_tpu_torch.kernels import split, wide
    from gpu_quantum_simulator_tpu_torch.parallel import sharded_prefetch

    split.run_split_block.launches["mat_high"] += 3
    wide.kh0_chain.launches["default"] += 2
    sharded_prefetch.gswap.launches += 1
    got = profiling._launches()
    assert got["launches/run_split_block/mat_high"] >= 3
    assert got["launches/kh0_chain/default"] >= 2
    assert got["launches/gswap"] >= 1
    telemetry.reset()
    assert set(profiling._launches().values()) == {0}
