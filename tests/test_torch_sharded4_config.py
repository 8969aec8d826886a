"""The four-card sharded configuration of the benchmark, on the CPU.

``benchmark/configs/grover2445-n34-sharded4.json`` runs ``strategy=
"sharded"`` with ``mesh_shape`` (4,): one shard a card.  Here, at widths a
CPU holds, with the four devices ``["cpu"] * 4``: the plain four-quarter
reference (``benchmark/references/statevector_sharded.py``) against the
complex128 one gate kind by gate kind on the top qubits; the port's
segmented sharded chain against that reference through the benchmark's
own comparisons (``check.amp_err``, ``check.shots_z``); the exchange's
byte counters; and the cell's per-layer readers on hand-made traces and
counter records.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check, program_spans  # noqa: E402
from benchmark.families import grover_like  # noqa: E402
from benchmark.harness import Run, _load_module, to_circuit  # noqa: E402
from benchmark.references import statevector as SV  # noqa: E402
from benchmark.roofline import KernelTable  # noqa: E402
from benchmark.tracing import TraceView  # noqa: E402

import gpu_quantum_simulator_tpu_torch as T  # noqa: E402
from gpu_quantum_simulator_tpu_torch import telemetry  # noqa: E402

REF = _load_module(os.path.join(ROOT, "benchmark", "references",
                                "statevector_sharded.py"))
CONFIG = os.path.join(ROOT, "benchmark", "configs",
                      "grover2445-n34-sharded4.json")
TABLE = KernelTable(os.path.join(ROOT, "benchmark", "kernels"))
CPU4 = ["cpu"] * 4
N = 12


def _metric(name):
    return _load_module(os.path.join(ROOT, "benchmark", "metrics",
                                     name + ".py"))


def _config(n):
    with open(CONFIG) as f:
        cfg = json.load(f)
    return {**cfg, "num_qubits": n}


def _sim(**kw):
    return T.Simulator(T.SimulatorConfig(
        **{**_config(N)["simulator"], "precision": "high", **kw}),
        device=CPU4)


# ------------------------------------------------------ the plain reference
TOP_GATES = {
    "cx top, top": [("cx", (10, 11), ()), ("cx", (11, 10), ())],
    "cx local, top": [("cx", (3, 11), ()), ("cx", (0, 10), ())],
    "cx top, local": [("cx", (10, 4), ()), ("cx", (11, 9), ())],
    "sx, x on a top qubit": [("sx", (10,), ()), ("x", (11,), ()),
                             ("sx", (11,), ()), ("x", (10,), ())],
    "rz on a top qubit": [("rz", (11,), (0.7,)), ("rz", (10,), (-2.1,))],
}


def _spread(seed):
    """Every qubit in superposition with seeded phases, so that each gate
    on the top qubits moves amplitudes that are not zero."""
    rng = np.random.default_rng(seed)
    gates = [("sx", (q,), ()) for q in range(N)]
    gates += [("rz", (q,), (float(rng.uniform(-6, 6)),)) for q in range(N)]
    gates += [("cx", (q, (q + 5) % N), ()) for q in range(N)]
    return gates


@pytest.mark.parametrize("kind", sorted(TOP_GATES))
def test_quarters_equal_the_complex128_reference(kind):
    gates = _spread(7)
    for _ in range(3):
        gates += TOP_GATES[kind] + _spread(len(gates))
    ref = SV.simulate(gates, N)
    got = REF.simulate(gates, N, block=64)
    assert got.numel() == ref.numel() and got.device == torch.device("cpu")
    flat = got[0:got.numel()].to(torch.complex128)
    assert float((flat - ref).norm() / ref.norm()) <= 1e-5
    idx = torch.tensor([0, 1023, 1024, 2047, 3072, 4095, 17])
    assert torch.allclose(got[idx].to(torch.complex128), ref[idx],
                          atol=1e-6)
    # a slice that spans two quarters is joined
    assert torch.equal(got[1000:1100], flat[1000:1100].to(torch.complex64))


def test_quarters_on_the_cell_circuit():
    gates = grover_like.gates(_config(N), [31, 1, 0])
    ref = SV.simulate(gates, N)
    got = REF.simulate(gates, N)
    flat = got[0:got.numel()].to(torch.complex128)
    assert float((flat - ref).norm() / ref.norm()) <= 1e-5


# ------------------------------------------ the port against the reference
def test_config_mesh_shape_from_json_is_a_tuple():
    cfg = T.SimulatorConfig(**_config(N)["simulator"])
    assert cfg.mesh_shape == (4,) and cfg.mesh_axis_names == ("amp",)
    assert hash(cfg) == hash(T.SimulatorConfig(strategy="sharded",
                                               mesh_shape=(4,)))


def test_port_on_four_devices_against_the_reference(seed=2147483693):
    n = 13                                   # nl = 11: the segmented chain
    gates = grover_like.gates(_config(n), [seed, 1, 0])
    c = to_circuit(gates, n)
    sim = _sim()
    assert sim._shard_segmented(n)
    re, im, _ = sim.run_device(c)
    assert [r.numel() for r in re] == [1 << 11] * 4
    ref = REF.simulate(gates, n)
    assert check.amp_err((re, im), ref) <= 1e-3
    shots = sim.sample(c, 10_000, seed=seed)
    assert check.shots_bad(shots, n, 10_000) == 0
    assert check.shots_z(shots, ref) <= 6


def test_exchange_counters_on_one_device():
    """On ``["cpu"] * 4`` every half a gswap ships stays on one device:
    the local bytes are the kept and the received halves of every shard,
    both components; no byte crosses between devices.  The CPU takes the
    torch copies: the gswap kernel never launches."""
    from gpu_quantum_simulator_tpu_torch.parallel import sharded_prefetch

    n = 13
    c = to_circuit(grover_like.gates(_config(n), [11, 1, 0]), n)
    before = telemetry.counters()
    _sim().run_device(c)
    after = telemetry.counters()

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)

    gswaps = delta("launches/gswap")
    assert gswaps > 0 and gswaps == sharded_prefetch.gswap.launches - \
        before["launches/gswap"]
    shard = (1 << n) // 4
    assert delta("gswap_local_bytes") == gswaps * 4 * shard * 2 * 4
    assert delta("gswap_peer_bytes") == 0
    assert "launches/gswap_halves" in after
    assert delta("launches/gswap_halves") == 0


# ------------------------------------------------------------ the readers
GSWAP = ("void gswap_halves_kernel(float4 const*, float4 const*, float4 "
         "const*, float4 const*, float4*, float4*, long long, int, int)")
MAT = ("void (anonymous namespace)::mat_high_kernel<true>((anonymous "
       "namespace)::FlatMap, unsigned char const*)")
HAND = {"gswap_halves_kernel", "mat_high_kernel", "gather_step_kernel"}


def _ev(cat, name, ts, dur, device=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if device is not None:
        e["args"] = {"device": device}
    return e


MS = 1e3                  # a trace's clock is microseconds


def _trace(n):
    """Two requests (0-1000, 1000-2000 ms) over four cards: gswap launches
    of 150 ms (two overlapping) on card 0, 200 on card 1, and on card 2
    one at the very times of one of card 0's; mat steps besides."""
    events = [_ev("user_annotation", "sample#0", 0.0, 1000 * MS),
              _ev("user_annotation", "sample#1", 1000 * MS, 1000 * MS),
              _ev("kernel", GSWAP, 100 * MS, 100 * MS, 0),
              _ev("kernel", GSWAP, 150 * MS, 100 * MS, 0),
              _ev("kernel", GSWAP, 1100 * MS, 200 * MS, 1),
              _ev("kernel", GSWAP, 100 * MS, 100 * MS, 2),
              _ev("kernel", MAT, 300 * MS, 400 * MS, 0),
              _ev("kernel", MAT, 1300 * MS, 500 * MS, 3),
              _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 5 * MS,
                  10 * MS, 0)]
    return TraceView(events, HAND, TABLE, n, chips=4)


def test_gswap_ms_is_each_cards_union_over_the_cards():
    run = Run(trace=_trace(34), requests=[(0, 1, 1), (1, 2, 2)])
    # cards: 150 + 200 + 100 + 0 ms, over 4 cards, over 2 requests
    assert _metric("gswap_ms").read(run) == pytest.approx(
        (150 + 200 + 100) / 4 / 2)
    assert _metric("gswap_ms").read(Run(trace=None, requests=[])) is None


def _records(counters):
    return [{"name": "qsim/sample", "id": i + 1, "parent": None,
             "request": i + 1, "start": 10.1 + 10 * i, "end": 19.9 + 10 * i,
             "counters": counters} for i in range(2)]


def test_gswap_rate_and_count_read_the_counters(monkeypatch):
    peer = 3 * 2**30
    monkeypatch.setattr(program_spans, "program_records",
                        lambda: _records({"gswap_peer_bytes": peer,
                                          "launches/gswap": 64}))
    run = Run(trace=_trace(34), requests=[(10.0, 20.0, 20.0),
                                          (20.0, 30.0, 30.0)])
    # 2 requests' bytes over 4 cards, over the cards' 450/4 ms of gswaps
    assert _metric("gswap_gbps").read(run) == pytest.approx(
        2 * peer / 4 / ((150 + 200 + 100) / 4 * 1e-3) / 1e9)
    assert _metric("gswaps_per_circuit").read(run) == 64
    monkeypatch.setattr(program_spans, "program_records",
                        lambda: _records({"launches/gswap": 64}))
    assert _metric("gswap_gbps").read(run) is None      # nothing crossed
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    assert _metric("gswaps_per_circuit").read(run) is None


def test_shard_roofline_is_the_kernel_roofline_at_the_shard_width():
    n = 34
    run = Run(trace=_trace(n), config=_config(n), requests=[])
    got = _metric("shard_roofline").read(run)
    assert got == pytest.approx(_trace(n - 2).kernel_roofline_pct())
    assert got == pytest.approx(_trace(n).kernel_roofline_pct() / 4)
    assert 0 < got <= 100
    one = {**_config(n), "simulator": {}}
    assert _metric("shard_roofline").read(
        Run(trace=_trace(n), config=one, requests=[])) == pytest.approx(
            _trace(n).kernel_roofline_pct())
    assert math.isfinite(got)
