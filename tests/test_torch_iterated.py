"""The facade's program entry points of the port against the JAX package's,
on the CPU: ``run_device_iterated``, ``run_device_parts`` and
``run_many``.

On the CPU every iterated arm is the eager loop (the card replays a CUDA
graph instead, held bit for bit to the same loop by chip_smoke.py).  Bars:
5e-6 against the JAX package and against the unrolled circuit, the
per-gate engines' bar of tests/test_engines.py; the expectations of
``run_many(terms=)`` 1e-6 relative to max(1, |<H>|): they are float32
sums in both packages, so their rounding grows with the value (a MaxCut
cost of ~7.5 is 1 ulp from 1e-6).
"""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine.simulator import Simulator as JSimulator
from gpu_quantum_simulator_tpu.ir.circuit import Circuit as JCircuit

import torch

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch.engine import prefetch as TPF
from gpu_quantum_simulator_tpu_torch.engine.graphs import iterate
from gpu_quantum_simulator_tpu_torch.ir.circuit import Circuit
from gpu_quantum_simulator_tpu_torch.observables import expectation_pauli_sum

ENGINE_TOL = 5e-6      # tests/test_engines.py's per-gate bar
EXP_TOL = 1e-6
STRATEGIES = ("mxu", "prefetch", "vmem", "megakernel")


def _sim(strategy, **kw):
    return T.Simulator(T.SimulatorConfig(strategy=strategy, **kw),
                       device="cpu")


def _jsim(strategy, **kw):
    return JSimulator(JConfig(strategy=strategy, **kw))


def _state(re, im):
    return (np.asarray(re, dtype=np.float64)
            + 1j * np.asarray(im, dtype=np.float64))


def _tstate(re, im):
    return _state(re.numpy(), im.numpy())


# (family, args, marked) -> (prefix, body, repetitions) of both packages
FAMILIES = {
    "grover": ("grover_parts", (6, 41), 41),          # 6 data + 4 ancillas
    "trotter": ("trotter_tfim_parts", (9, 0.1, 1.0, 0.7, 5), None),
    "qaoa": ("qaoa_maxcut_parts", (10, None, 0.6, 0.3, 3), None),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_iterated_matches_unrolled_and_jax(strategy, family):
    name, args, marked = FAMILIES[family]
    prefix, body, reps = getattr(TM, name)(*args)
    jprefix, jbody, jreps = getattr(JM, name)(*args)
    sim = _sim(strategy)
    re, im, nops = sim.run_device_iterated(body, reps, prefix=prefix)
    got = _tstate(re, im)
    unrolled = Circuit(prefix.num_qubits, list(prefix.gates))
    for _ in range(reps):
        unrolled.gates.extend(body.gates)
    want = sim.run(unrolled)
    assert np.max(np.abs(got - want)) < ENGINE_TOL
    jre, jim, jnops = _jsim(strategy).run_device_iterated(jbody, jreps,
                                                          prefix=jprefix)
    assert np.max(np.abs(got - _state(jre, jim))) < ENGINE_TOL
    assert nops == jnops
    if marked is not None:
        assert int(np.argmax(np.abs(got) ** 2)) == marked


@pytest.mark.parametrize("strategy", ("mxu", "prefetch"))
def test_iterated_zero_reps_and_suffix(strategy):
    c1 = TM.ghz(10)
    re, im, _ = _sim(strategy).run_device_iterated(
        Circuit(10).x(0), 0, prefix=c1, suffix=Circuit(10).x(9))
    jre, jim, _ = _jsim(strategy).run_device_iterated(
        JCircuit(10).x(0), 0, prefix=JM.ghz(10), suffix=JCircuit(10).x(9))
    want = T.Simulator(T.SimulatorConfig(strategy="reference"),
                       device="cpu").run(TM.ghz(10).x(9))
    assert np.max(np.abs(_tstate(re, im) - want)) < ENGINE_TOL
    assert np.max(np.abs(_tstate(re, im) - _state(jre, jim))) < ENGINE_TOL


@pytest.mark.parametrize("strategy", ("pallas", "reference"))
def test_iterated_refuses_other_strategies(strategy):
    with pytest.raises(ValueError, match="run_device_iterated supports"):
        _sim(strategy).run_device_iterated(TM.ghz(9), 2)


def test_iterated_refuses_unequal_widths():
    with pytest.raises(ValueError, match="same qubit count"):
        _sim("mxu").run_device_iterated(TM.ghz(9), 2, prefix=TM.ghz(10))
    with pytest.raises(ValueError, match="same qubit count"):
        _sim("prefetch").run_device_iterated(TM.ghz(9), 2, suffix=TM.ghz(8))


def test_iterated_sharded_names_its_roadmap_item():
    """The sharded strategy iterates (ported): prefix + body^k over eight
    shards on the segmented engine and over four on the dense one, shard
    lists in the original basis, against the unrolled circuit."""
    from gpu_quantum_simulator_tpu_torch.parallel.sharded import join_shards
    from gpu_quantum_simulator_tpu_torch.ref.cpu import simulate_reference

    prefix, body, _ = TM.grover_parts(6, 37)        # n = 10
    want = simulate_reference(TM.grover(6, 37, iterations=3))
    for mesh, segmented in (((8,), False), ((2,), True)):
        sim = T.Simulator(T.SimulatorConfig(strategy="sharded",
                                            mesh_shape=mesh),
                          device=["cpu"] * 8)
        assert sim._shard_segmented(body.num_qubits) == segmented
        re, im, nops = sim.run_device_iterated(body, 3, prefix=prefix)
        assert len(re) == mesh[0] and nops > 0
        assert np.max(np.abs(join_shards(re, im) - want)) <= ENGINE_TOL


def test_iterate_helper_refuses_inplace_programs():
    from gpu_quantum_simulator_tpu_torch.engine.simulator import _fuse_pipeline

    c = TM.grover_like(10, 60, 1)
    ops = _fuse_pipeline(c, 7, max_high=2, window=8)
    prog = TPF.build_prefetch_program(ops, 10, device="cpu", inplace=True)
    with pytest.raises(ValueError, match="inplace=False"):
        TPF.iterate_program(prog, 3)
    flat = TPF.build_prefetch_program(ops, 10, device="cpu",
                                      final_layout=np.arange(10))
    from gpu_quantum_simulator_tpu_torch.ops.apply import initial_state_parts

    re, im = initial_state_parts(10, device="cpu")
    got = TPF.iterate_program(flat, 3)(re.clone(), im.clone())
    for _ in range(3):
        re, im = flat(re, im)
    assert torch.equal(got[0], re) and torch.equal(got[1], im)


def test_iterate_is_the_eager_loop_on_the_cpu():
    from gpu_quantum_simulator_tpu_torch.engine.simulator import _fuse_pipeline
    from gpu_quantum_simulator_tpu_torch.engine.wide import build_wide_program
    from gpu_quantum_simulator_tpu_torch.ops.apply import initial_state_parts

    ops = _fuse_pipeline(TM.grover_like(9, 60, 2), 7, max_high=2, window=8,
                         cost_model=True)
    prog = build_wide_program(ops, 9, device="cpu")
    re, im = initial_state_parts(9, device="cpu")
    got = iterate(prog, re.clone(), im.clone(), 4)
    for _ in range(4):
        re, im = prog(re, im)
    assert torch.equal(got[0], re) and torch.equal(got[1], im)


@pytest.mark.parametrize("strategy", ("mxu", "prefetch", "vmem",
                                      "megakernel"))
def test_run_device_parts_composes_and_leaves_the_input(strategy):
    n = 10
    c1, c2 = TM.grover_like(n, 90, 5), TM.random_circuit(n, 70, seed=6)
    sim = _sim(strategy)
    re0, im0, _ = sim.run_device(c1)
    keep = (re0.clone(), im0.clone())
    re, im, nops = sim.run_device_parts(c2, (re0, im0))
    assert torch.equal(re0, keep[0]) and torch.equal(im0, keep[1])
    both = Circuit(n, list(c1.gates) + list(c2.gates))
    want = sim.run(both)
    assert np.max(np.abs(_tstate(re, im) - want)) < ENGINE_TOL
    # numpy parts are taken as well, and the JAX package agrees
    jre, jim, jnops = _jsim(strategy).run_device_parts(
        JM.random_circuit(n, 70, seed=6), (re0.numpy(), im0.numpy()))
    assert np.max(np.abs(_tstate(re, im) - _state(jre, jim))) < ENGINE_TOL
    assert nops == jnops
    again = sim.run_device_parts(c2, (re0.numpy(), im0.numpy()))
    assert torch.equal(again[0], re) and torch.equal(again[1], im)


def test_run_device_parts_rejects_a_wrong_length():
    with pytest.raises(ValueError, match="wrong length"):
        _sim("mxu").run_device_parts(TM.ghz(9), (np.zeros(8), np.zeros(8)))


@pytest.mark.parametrize("strategy", ("mxu", "prefetch"))
def test_run_many_states_match_jax(strategy):
    cs = [TM.grover_like(9, 60, s) for s in range(5)]
    js = [JM.grover_like(9, 60, s) for s in range(5)]
    got = _sim(strategy).run_many(cs, throttle=2)
    want = _jsim(strategy).run_many(js, throttle=2)
    assert len(got) == len(want) == 5
    for g, w, c in zip(got, want, cs):
        assert g.dtype == w.dtype
        assert np.max(np.abs(g - w)) < ENGINE_TOL
        assert np.array_equal(g, _sim(strategy).run(c))
    assert _sim(strategy).run_many([]) == []


@pytest.mark.parametrize("strategy", ("mxu", "prefetch"))
def test_run_many_terms_match_jax_and_expectation(strategy):
    n = 10
    gammas = [0.1, 0.35, 0.6, 0.85]
    cs = [TM.qaoa_maxcut(n, gammas=(g,), betas=(0.4,)) for g in gammas]
    js = [JM.qaoa_maxcut(n, gammas=(g,), betas=(0.4,)) for g in gammas]
    terms = TM.maxcut_cost_terms(n) + [(0.3, "X0 Y5")]
    got = _sim(strategy).run_many(cs, terms=terms, throttle=3)
    want = _jsim(strategy).run_many(js, terms=terms, throttle=3)
    assert got.shape == (4,)
    bar = EXP_TOL * np.maximum(1.0, np.abs(want))
    assert np.all(np.abs(got - want) <= bar)
    each = [expectation_pauli_sum(c, terms, T.SimulatorConfig(
        strategy=strategy), device="cpu") for c in cs]
    assert np.all(np.abs(got - np.asarray(each)) <= bar)
    assert _sim(strategy).run_many([], terms=terms).shape == (0,)
    with pytest.raises(ValueError, match="equal widths"):
        _sim(strategy).run_many([TM.ghz(9), TM.ghz(10)], terms=terms)


def test_graph_launch_counts_follow_replays():
    """A capture launches nothing: what the wrappers counted while it
    recorded is taken back, and each replay adds it once."""
    from gpu_quantum_simulator_tpu_torch.engine import graphs as G
    from gpu_quantum_simulator_tpu_torch.kernels import block, wide

    block.reset_launches()
    wide.reset_launches()
    before = G.launch_counts()
    block.run_block.launches["mat"] += 2
    wide.mm_step_high.launches += 1
    after = G.launch_counts()
    delta = {k: v - before[k] for k, v in after.items() if v != before[k]}
    assert delta == {(block.run_block, "mat"): 2,
                     (wide.mm_step_high, None): 1}
    G.add_launches(delta, -1)
    assert G.launch_counts() == before
    G.add_launches(delta, 5)
    assert block.run_block.launches["mat"] == 10
    assert wide.mm_step_high.launches == 5
    block.reset_launches()
    wide.reset_launches()


def test_one_live_graph_per_device(monkeypatch):
    """graph_of keeps one graph a device: the same program and shape reuse
    it, another program drops it before its own capture."""
    import gc
    import weakref

    from gpu_quantum_simulator_tpu_torch.engine import graphs as G

    class Captured:
        def __init__(self, prog, re, im):
            assert not G._LIVE, "the previous graph was not dropped first"
            self.prog, self.re = prog, re

    monkeypatch.setattr(G, "ProgramGraph", Captured)
    monkeypatch.setattr(G, "_LIVE", {})
    re = torch.zeros(8)

    def a(x, y):
        return x, y

    def b(x, y):
        return x, y

    first = G.graph_of(a, re, re)
    assert G.graph_of(a, re, re) is first
    gone = weakref.ref(first)
    del first
    second = G.graph_of(b, re, re)
    gc.collect()
    assert gone() is None and list(G._LIVE.values()) == [second]
    assert G.graph_of(b, torch.zeros(16), torch.zeros(16)) is not second
    G.release()
    assert not G._LIVE
