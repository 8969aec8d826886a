"""The port's mesh-sharded engine against the JAX package's.

The counterpart of tests/test_sharded.py, a case for each of its tests.
The JAX package runs its mesh on the eight virtual CPU devices of
tests/conftest.py; the port runs the same mesh as one process over the
device list ``["cpu"] * 8`` (parallel/mesh.py).  The same numpy-seeded
circuits go through both: plans item for item (``plan_sharded`` in every
arm), the cost model's estimates float for float, amplitudes within the
JAX tests' TOL of ``simulate_reference`` and of the JAX sharded run.  The
port runs its kernels' plain torch versions here.
"""

import numpy as np
import pytest
import torch

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine import plancost as JPC
from gpu_quantum_simulator_tpu.engine.simulator import Simulator as JSimulator
from gpu_quantum_simulator_tpu.engine.simulator import _fuse_pipeline as j_fuse
from gpu_quantum_simulator_tpu.ir.oplist import circuit_to_ops as j_ops
from gpu_quantum_simulator_tpu.passes import shard as JSH

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch.engine import plancost as TPC
from gpu_quantum_simulator_tpu_torch.engine.simulator import _fuse_pipeline as t_fuse
from gpu_quantum_simulator_tpu_torch.ir.circuit import Circuit
from gpu_quantum_simulator_tpu_torch.ir.oplist import circuit_to_ops
from gpu_quantum_simulator_tpu_torch.parallel import mesh as TMESH
from gpu_quantum_simulator_tpu_torch.parallel import sharded as TSD
from gpu_quantum_simulator_tpu_torch.passes.shard import SwapItem, plan_sharded
from gpu_quantum_simulator_tpu_torch.ref.cpu import simulate_reference

TOL = 2e-5                 # tests/test_sharded.py
MAT_TOL = 1e-12            # both packages fuse through one native fuser
CPU8 = ["cpu"] * 8


def _sim(mesh_shape=None, devices=CPU8, **kw):
    return T.Simulator(T.SimulatorConfig(strategy="sharded",
                                         mesh_shape=mesh_shape, **kw),
                       device=devices)


def _run(circuit, mesh_shape=None, **kw):
    return _sim(mesh_shape, **kw).run(circuit)


def _jax_run(circuit, mesh_shape=None, **kw):
    cfg = JConfig(strategy="sharded", mesh_shape=mesh_shape, **kw)
    return np.asarray(JSimulator(cfg).run(circuit))


def _same(t_circuit, j_circuit):
    assert [(g.name, g.qubits, g.params) for g in t_circuit.gates] == \
        [(g.name, g.qubits, g.params) for g in j_circuit.gates]


def _assert_same_plan(got, want):
    """Item for item: swaps, local swaps and ops (matrices to f64 noise)."""
    assert len(got.items) == len(want.items)
    for a, b in zip(got.items, want.items):
        assert type(a).__name__ == type(b).__name__
        if isinstance(b, (JSH.SwapItem, JSH.LocalSwapItem)):
            assert (a.pos_a, a.pos_b) == (b.pos_a, b.pos_b)
        else:
            assert a.kind == b.kind and tuple(a.qubits) == tuple(b.qubits)
            if b.u is not None:
                assert np.max(np.abs(a.u - np.asarray(b.u))) <= MAT_TOL
    assert np.array_equal(got.final_position, want.final_position)
    assert (got.num_swaps, got.num_local_swaps, got.num_qubits,
            got.num_global) == (want.num_swaps, want.num_local_swaps,
                                want.num_qubits, want.num_global)


def test_devices_available():
    """Eight shards over ``["cpu"] * 8``, the JAX tests' eight virtual
    devices; with no device list the mesh is every visible card, and a host
    without one raises instead of falling back to the CPU."""
    mesh = TMESH.make_mesh(None, ("amp",), CPU8)
    assert mesh.shape["amp"] == 8 and TMESH.num_global_qubits(mesh) == 3
    assert mesh.device_list == [torch.device("cpu")] * 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TMESH.make_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            T.Simulator(T.SimulatorConfig(strategy="sharded"))


@pytest.mark.parametrize("mesh", [(1,), (2,), (4,), (8,)])
def test_ghz_parity_all_mesh_sizes(mesh):
    c = TM.ghz(7)
    got = _run(c, mesh_shape=mesh)
    want = simulate_reference(c)
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, _jax_run(JM.ghz(7), mesh), atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_circuit_parity_8way(seed):
    c = TM.random_circuit(8, 150, seed=seed)
    _same(c, JM.random_circuit(8, 150, seed=seed))
    got = _run(c, mesh_shape=(8,))
    np.testing.assert_allclose(got, simulate_reference(c), atol=TOL)
    np.testing.assert_allclose(
        got, _jax_run(JM.random_circuit(8, 150, seed=seed), (8,)), atol=TOL)


def test_grover_parity_4way():
    """The JAX test's Grover file (grover_3_18.qasm) is not committed; a
    Grover search of the same width through the same 4-way mesh and
    max_fused_qubits=4."""
    c = TM.grover(5, marked=18, iterations=3)
    got = _run(c, mesh_shape=(4,), max_fused_qubits=4)
    want = simulate_reference(c)
    np.testing.assert_allclose(got, want, atol=TOL)
    assert int(np.argmax(np.abs(got))) == 18


def test_gates_on_global_qubits_force_swaps():
    n, d = 6, 3
    c = Circuit(n)
    c.h(5).cx(5, 4).cx(4, 3)
    plan = plan_sharded(circuit_to_ops(c), n, d)
    assert plan.num_swaps > 0
    got = _run(c, mesh_shape=(8,), max_fused_qubits=3)
    np.testing.assert_allclose(got, simulate_reference(c), atol=TOL)


def test_plan_keeps_ops_local():
    c = TM.random_circuit(8, 100, seed=3)
    plan = plan_sharded(circuit_to_ops(c), 8, 3)
    local_n = 5
    for item in plan.items:
        if isinstance(item, SwapItem):
            assert item.pos_a >= local_n and item.pos_b < local_n
        else:
            assert all(p < local_n for p in item.qubits)
    _assert_same_plan(plan, JSH.plan_sharded(
        j_ops(JM.random_circuit(8, 100, seed=3)), 8, 3))


def test_plan_rejects_too_wide_ops():
    from gpu_quantum_simulator_tpu_torch.passes.fuse_k import fuse_k

    ops = fuse_k(TM.ghz(4), max_qubits=4)  # one 4-wide block
    with pytest.raises(ValueError, match="only 3 are local"):
        plan_sharded(ops, 4, 1)


def test_permute_reduces_swaps():
    from gpu_quantum_simulator_tpu_torch.passes.permute import plan_permutation

    n, d = 8, 3
    c = Circuit(n)
    for _ in range(20):
        c.cx(7, 6).h(7).h(6)
    base = plan_sharded(circuit_to_ops(c), n, d)
    opt = plan_sharded(circuit_to_ops(c.relabeled(plan_permutation(c))), n, d)
    assert opt.num_swaps < base.num_swaps
    assert opt.num_swaps <= 2


def test_deep_circuit_many_swaps_n12():
    """2445 gates at n=12 over 4 shards (nl = 10: the segmented engine, as
    in the JAX package), against the reference."""
    c = TM.grover_like(12, num_gates=2445, seed=0)
    sim = _sim((4,))
    assert sim._shard_segmented(12)
    np.testing.assert_allclose(sim.run(c), simulate_reference(c), atol=TOL)


@pytest.mark.parametrize("policy", ["cold", "first"])
def test_two_level_local_swaps_planned(policy):
    """At local_n > 7 the planner emits LocalSwapItems whenever an op would
    touch 3+ shard-high positions; both victim policies plan item for item
    as the JAX planner."""
    c = TM.grover_like(12, num_gates=2445, seed=0)
    ops = t_fuse(c, 7, max_high=2)
    plan = plan_sharded(ops, 12, 2, max_local_high=2, victim_policy=policy)
    for item in plan.items:
        if hasattr(item, "kind") and item.kind == "u":
            assert sum(1 for p in item.qubits if p >= 7) <= 2
    assert plan.num_local_swaps > 0 or policy == "first"
    jops = j_fuse(JM.grover_like(12, num_gates=2445, seed=0), 7, max_high=2)
    _assert_same_plan(plan, JSH.plan_sharded(jops, 12, 2, max_local_high=2,
                                             victim_policy=policy))


def test_auto_mesh():
    """mesh_shape=None builds the largest power-of-two mesh of the device
    list; a shape larger than its devices raises."""
    c = TM.random_circuit(9, 80, seed=3)
    sim = _sim(None)
    assert sim.mesh().shape["amp"] == 8
    np.testing.assert_allclose(sim.run(c), simulate_reference(c), atol=TOL)
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        _sim((8,), devices=["cpu"] * 4).run(c)
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        T.Simulator(T.SimulatorConfig(strategy="sharded", mesh_shape=(8,)),
                    device="cpu").run(c)


def test_non_power_of_two_devices():
    """A mesh built from 5 devices truncates to 4."""
    mesh = TMESH.make_mesh(None, ("amp",), devices=["cpu"] * 5)
    assert mesh.shape["amp"] == 4
    with pytest.raises(ValueError, match="power of two"):
        TMESH.num_global_qubits(TMESH.make_mesh((3,), ("amp",), CPU8))


def test_restore_layout_roundtrip():
    """restore_layout plans end at the entry layout, item for item the JAX
    planner's; an ``initial_layout`` plan chains from it."""
    c = TM.grover_like(10, num_gates=400, seed=9)
    ops = t_fuse(c, 5, max_high=2)
    plan = plan_sharded(ops, 10, 3, max_local_high=2, restore_layout=True)
    np.testing.assert_array_equal(plan.final_position, np.arange(10))
    jops = j_fuse(JM.grover_like(10, num_gates=400, seed=9), 5, max_high=2)
    _assert_same_plan(plan, JSH.plan_sharded(jops, 10, 3, max_local_high=2,
                                             restore_layout=True))
    layout = np.random.default_rng(4).permutation(10)
    got = plan_sharded(ops, 10, 3, max_local_high=2, initial_layout=layout,
                       restore_layout=True)
    np.testing.assert_array_equal(got.final_position, layout)
    _assert_same_plan(got, JSH.plan_sharded(
        jops, 10, 3, max_local_high=2, initial_layout=layout,
        restore_layout=True))


def test_initial_state_resume_sharded():
    """Split a circuit in two and resume from the midpoint state through the
    sharded engine."""
    n = 10
    full = TM.grover_like(n, num_gates=300, seed=17)
    first, second = Circuit(n), Circuit(n)
    first.gates = full.gates[:150]
    second.gates = full.gates[150:]
    sim = _sim((4,))
    mid = sim.run(first)
    got = sim.run(second, initial=mid)
    np.testing.assert_allclose(got, simulate_reference(full), atol=TOL)


def test_run_device_iterated_sharded():
    """Grover prefix + body^k through the dense sharded engine: shard lists
    out, in the original basis, against the unrolled circuit."""
    n = 5
    prefix, body, _iters = TM.grover_parts(n, marked=3)
    sim = _sim((4,))
    re, im, _ = sim.run_device_iterated(body, 3, prefix=prefix)
    assert isinstance(re, list) and len(re) == 4
    got = TSD.join_shards(re, im)
    want = simulate_reference(TM.grover(n, marked=3, iterations=3))
    np.testing.assert_allclose(got, want, atol=TOL)


def test_sharded_device_side_sampling_n23():
    """n > 22 samples on the sharded state (sampling.py shard by shard,
    nothing of 2^n joined): the same indices as the flat sampler on the
    joined state with the same seed, and the norm, top amplitudes and
    amplitude gathers of the flat helpers."""
    from gpu_quantum_simulator_tpu_torch import sampling as S

    n = 23
    c = TM.grover_like(n, num_gates=30, seed=1)
    sim = _sim((8,))
    s = sim.sample(c, 64, seed=0)
    assert s.shape == (64,) and s.dtype == np.int64
    assert s.min() >= 0 and s.max() < (1 << n)
    re, im, _ = sim.run_device(c)
    assert len(re) == 8 and re[0].shape == (1 << (n - 3),)
    flat_re, flat_im = torch.cat(re), torch.cat(im)
    assert np.array_equal(S.sample_state_device(re, im, n, 500, seed=3),
                          S.sample_state_device(flat_re, flat_im, n, 500,
                                                seed=3))
    assert np.array_equal(s, S.sample_state_device(re, im, n, 64, seed=0))
    assert abs(S.norm_device(re, im) - S.norm_device(flat_re, flat_im)) < 1e-6
    pv, pi = S.top_amplitudes_device(re, im, 5)
    fv, fi = S.top_amplitudes_device(flat_re, flat_im, 5)
    np.testing.assert_allclose(pv, fv, rtol=1e-6)
    idx = [0, 5, (1 << 20) + 7, (1 << n) - 1]
    np.testing.assert_array_equal(S.amplitudes_device(re, im, idx),
                                  S.amplitudes_device(flat_re, flat_im, idx))
    # the direct (one-CDF) arm below STAGE_SPLIT_MIN as well
    small = TM.random_circuit(12, 120, seed=2)
    re, im, _ = sim.run_device(small)
    assert np.array_equal(S.sample_state_device(re, im, 12, 300, seed=5),
                          S.sample_state_device(torch.cat(re), torch.cat(im),
                                                12, 300, seed=5))


def test_sharded_observables_compose():
    """expectation_z and expectation_pauli_sum reduce sharded states shard
    by shard (no join), against the flat mxu state."""
    from gpu_quantum_simulator_tpu_torch.observables import expectation_pauli_sum
    from gpu_quantum_simulator_tpu_torch.sampling import expectation_z

    n = 10
    c = TM.random_circuit(n, 120, seed=6)
    cfg = T.SimulatorConfig(strategy="sharded", mesh_shape=(8,))
    re, im, _ = T.Simulator(cfg, device=CPU8).run_device(c)
    got = expectation_z(re, im, [0, 4, 9], n)
    flat = T.Simulator(T.SimulatorConfig(strategy="mxu"), device="cpu")
    re_f, im_f, _ = flat.run_device(c)
    assert abs(got - expectation_z(re_f, im_f, [0, 4, 9], n)) < 1e-5

    terms = [(0.5, "Z0 Z4"), (-0.3, "X2"), (0.2, "Y7 Z1"), (0.4, "X8 Y9"),
             (-0.7, "Y9 Z8 X0")]
    e_flat = expectation_pauli_sum(c, terms, device="cpu")
    for method in ("state", "basis"):
        e_sharded = expectation_pauli_sum(c, terms, cfg, method=method,
                                          device=CPU8)
        assert abs(e_sharded - e_flat) < 1e-5


def test_quantum_volume_through_sharded_mesh():
    c = TM.quantum_volume(7, depth=3, seed=5)
    got = _run(c, mesh_shape=(8,))
    assert np.max(np.abs(got - simulate_reference(c))) < TOL


def test_ici_bytes_accounting():
    for n, d, gates, seed in [(10, 3, 200, 0), (12, 2, 500, 1), (9, 1, 300, 2)]:
        c = TM.grover_like(n, num_gates=gates, seed=seed)
        plan = plan_sharded(circuit_to_ops(c), n, d)
        n_swap_items = sum(1 for it in plan.items if isinstance(it, SwapItem))
        assert n_swap_items == plan.num_swaps
        assert plan.ici_bytes() == plan.num_swaps * (1 << (n - 1)) * 8
        assert plan.ici_bytes_per_device() * (1 << d) == plan.ici_bytes()
        assert plan.ici_bytes(real_bytes=8) == 2 * plan.ici_bytes()
        jplan = JSH.plan_sharded(
            j_ops(JM.grover_like(n, num_gates=gates, seed=seed)), n, d)
        assert (plan.ici_bytes(), plan.ici_bytes_per_device()) == \
            (jplan.ici_bytes(), jplan.ici_bytes_per_device())


def test_ici_half_block_is_analytic_minimum():
    """Swapping global bit p with local bit l moves amplitude i across
    shards iff bit_p(i) != bit_l(i): exactly half the indices, the bytes
    ``ici_bytes`` charges; ``swap_halves`` moves exactly those."""
    n, d = 9, 3
    local_n = n - d
    idx = np.arange(1 << n)
    for p in range(local_n, n):
        for l in range(local_n):
            bit_p = (idx >> p) & 1
            bit_l = (idx >> l) & 1
            swapped = idx & ~((1 << p) | (1 << l)) | (bit_l << p) | (bit_p << l)
            moved = int(np.sum((swapped >> local_n) != (idx >> local_n)))
            assert moved == 1 << (n - 1)
            # the exchange of shards itself: a state whose amplitude is its
            # index comes back with bits p and l exchanged
            x = torch.arange(1 << n, dtype=torch.float64)
            re, _ = TSD.swap_halves(list(x.view(8, -1)),
                                    list(x.view(8, -1)), p - local_n, l)
            assert torch.equal(torch.cat(re), x[torch.from_numpy(swapped)])
    plan = plan_sharded(circuit_to_ops(TM.ghz(n).cx(8, 0)), n, d)
    assert plan.num_swaps >= 1
    assert plan.ici_bytes() // (plan.num_swaps * 8) == 1 << (n - 1)


def test_victim_policy_ab_grover_profile():
    for n, d, gates, seed in [(12, 2, 2445, 0), (12, 3, 2445, 0),
                              (16, 3, 2445, 318)]:
        c = TM.grover_like(n, num_gates=gates, seed=seed)
        ops = t_fuse(c, min(7, n - d), max_high=2)
        cold = plan_sharded(ops, n, d, max_local_high=2)
        first = plan_sharded(ops, n, d, max_local_high=2,
                             victim_policy="first")
        assert cold.num_swaps < first.num_swaps
        assert cold.ici_bytes() < first.ici_bytes()
    with pytest.raises(ValueError, match="victim_policy"):
        plan_sharded([], 8, 2, victim_policy="hottest")


def test_victim_policy_ab_modeled_seconds():
    """estimate_shard_plan equals the JAX package's float for float, and
    its exchange term is derived from the plan's own bytes,
    ``ici_bytes_per_device`` spread over the swaps."""
    for n, d, gates, seed in [(12, 2, 2445, 0), (16, 3, 2445, 318)]:
        ops = t_fuse(TM.grover_like(n, num_gates=gates, seed=seed),
                     min(7, n - d), max_high=2)
        jops = j_fuse(JM.grover_like(n, num_gates=gates, seed=seed),
                      min(7, n - d), max_high=2)
        for policy in ("cold", "first"):
            plan = plan_sharded(ops, n, d, max_local_high=2,
                                victim_policy=policy)
            jplan = JSH.plan_sharded(jops, n, d, max_local_high=2,
                                     victim_policy=policy)
            got = TPC.estimate_shard_plan(plan, n)
            assert got == JPC.estimate_shard_plan(jplan, n)
        cold = plan_sharded(ops, n, d, max_local_high=2)
        first = plan_sharded(ops, n, d, max_local_high=2,
                             victim_policy="first")
        s_cold, acc_cold = TPC.estimate_shard_plan(cold, n)
        assert s_cold < TPC.estimate_shard_plan(first, n)[0]
        per_swap = cold.ici_bytes_per_device() // cold.num_swaps
        assert per_swap == (1 << (n - d - 1)) * 8
        want_ici = cold.num_swaps * (per_swap / (TPC.ICI_GBS * 1e9)
                                     + TPC.GSWAP_LAT_US * TPC.US)
        assert abs(acc_cold["gswap_ici"] - want_ici) < 1e-12


def test_choose_num_global_models_tradeoff():
    """choose_num_global picks the JAX package's split with its scores,
    float for float, for the dense and the segmented planner."""
    from gpu_quantum_simulator_tpu.ir.oplist import Op as JOp
    from gpu_quantum_simulator_tpu_torch.ir.oplist import Op

    n = 12
    h = np.sqrt(0.5) * np.array([[1, 1], [1, -1]], dtype=np.complex64)
    for ops, jops, want in (
            ([Op("u", (q % 4,), h) for q in range(64)],
             [JOp("u", (q % 4,), h) for q in range(64)], 3),
            ([Op("u", (n - 1 - (k % 5),), h) for k in range(64)],
             [JOp("u", (n - 1 - (k % 5),), h) for k in range(64)], None)):
        best, scores = TPC.choose_num_global(ops, n, 8)
        assert (best, scores) == JPC.choose_num_global(jops, n, 8)
        assert set(scores) == {1, 2, 3}
        if want is not None:
            assert best == want
        else:
            assert best < 3
    ops16 = t_fuse(TM.grover_like(16, num_gates=600, seed=7), 7, max_high=2)
    jops16 = j_fuse(JM.grover_like(16, num_gates=600, seed=7), 7, max_high=2)
    got = TPC.choose_num_global(ops16, 16, 8, segmented=True)
    assert got == JPC.choose_num_global(jops16, 16, 8, segmented=True)
    assert got[0] in got[1] and len(got[1]) >= 2


def test_entry_points_on_the_mesh():
    """``strategy="auto"`` with a mesh is the sharded engine (as in the JAX
    package); ``run_many`` (states and <H>) and ``run_device_parts`` (a flat
    pair in, shard lists out) run on it; n > 30 raises only outside it."""
    from gpu_quantum_simulator_tpu_torch.observables import expectation_pauli_sum

    res = T.Simulator(T.SimulatorConfig(strategy="auto", mesh_shape=(2,)),
                      device=CPU8).run_detailed(TM.ghz(10))
    assert res.strategy == "sharded"
    sim = _sim((4,))
    cs = [TM.qaoa_maxcut(10), TM.ghz(10)]
    terms = TM.maxcut_cost_terms(10)
    got = sim.run_many(cs, terms=terms)
    want = [expectation_pauli_sum(c, terms, device="cpu") for c in cs]
    assert np.max(np.abs(got - want)) < 1e-5
    for state, c in zip(sim.run_many(cs), cs):
        assert np.max(np.abs(state - simulate_reference(c))) < TOL
    first = TM.random_circuit(10, 50, seed=3)
    parts = T.Simulator(T.SimulatorConfig(strategy="mxu"),
                        device="cpu").run_device(first)[:2]
    re, im, _ = sim.run_device_parts(TM.ghz(10), parts)
    assert len(re) == 4
    want = simulate_reference(TM.random_circuit(10, 50, seed=3)
                              .compose(TM.ghz(10)))
    assert np.max(np.abs(TSD.join_shards(re, im) - want)) < TOL
    big = Circuit(31)
    big.h(0)
    for strategy in ("mxu", "prefetch"):
        with pytest.raises(ValueError, match="strategy='sharded'"):
            T.Simulator(T.SimulatorConfig(strategy=strategy),
                        device="cpu").run(big)
