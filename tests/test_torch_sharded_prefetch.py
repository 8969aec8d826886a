"""The port's segmented sharded engine against the JAX package's.

The counterpart of tests/test_sharded_prefetch.py, a case for each of its
tests.  The JAX package runs its mesh on the eight virtual CPU devices of
tests/conftest.py with its Pallas kernels in interpret mode; the port runs
eight shards over ``["cpu"] * 8`` on its kernels' plain torch versions.
Plans (``plan_prefetch(num_global=d)``) item for item, table chunks and
the portfolio's estimates float for float, amplitudes within the JAX
tests' TOL of ``simulate_reference`` and of the JAX sharded run.  The JAX
test's check of each chunk's MLIR size has no counterpart: the port
compiles no program a circuit.
"""

import numpy as np
import pytest
import torch

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine import plancost as JPC
from gpu_quantum_simulator_tpu.engine import prefetch as JPF
from gpu_quantum_simulator_tpu.engine.simulator import Simulator as JSimulator
from gpu_quantum_simulator_tpu.engine.simulator import _fuse_pipeline as j_fuse
from gpu_quantum_simulator_tpu.parallel import sharded_prefetch as JSP
from gpu_quantum_simulator_tpu.parallel.mesh import make_mesh as j_mesh

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch.engine import plancost as TPC
from gpu_quantum_simulator_tpu_torch.engine import prefetch as TPF
from gpu_quantum_simulator_tpu_torch.engine.simulator import _fuse_pipeline as t_fuse
from gpu_quantum_simulator_tpu_torch.ir.circuit import Circuit
from gpu_quantum_simulator_tpu_torch.parallel import sharded_prefetch as SP
from gpu_quantum_simulator_tpu_torch.parallel.mesh import make_mesh
from gpu_quantum_simulator_tpu_torch.parallel.sharded import join_shards
from gpu_quantum_simulator_tpu_torch.ref.cpu import simulate_reference

TOL = 2e-5                 # tests/test_sharded_prefetch.py
CPU8 = ["cpu"] * 8


def _sim(**kw):
    return T.Simulator(T.SimulatorConfig(strategy="sharded",
                                         shard_segmented=True, **kw),
                       device=CPU8)


def _simulate_segmented(circuit, **kw):
    sim = _sim(**kw)
    assert sim._shard_segmented(circuit.num_qubits), "need >= 9 local qubits"
    return sim.run(circuit)


def _jax_segmented(circuit, **kw):
    cfg = JConfig(strategy="sharded", shard_segmented=True, **kw)
    return np.asarray(JSimulator(cfg).run(circuit))


def _programs(n, gates, seed, **kw):
    """(port program, JAX program) of one circuit's fused ops over eight
    shards, layout-closed, as the JAX tests build theirs."""
    ops = t_fuse(TM.grover_like(n, gates, seed), 7, max_high=2, window=8)
    jops = j_fuse(JM.grover_like(n, gates, seed), 7, max_high=2, window=8)
    prog = SP.ShardedPrefetchProgram(ops, n, make_mesh(None, ("amp",), CPU8),
                                     final_layout=np.arange(n), **kw)
    jprog = JSP.ShardedPrefetchProgram(jops, n, j_mesh(None, ("amp",)),
                                       interpret=True,
                                       final_layout=np.arange(n), **kw)
    return prog, jprog


def _assert_same_plan(plan, jplan):
    assert len(plan.blocks) == len(jplan.blocks)
    for a, b in zip(plan.blocks, jplan.blocks):
        assert (a.kinds, a.midx, a.prologue, a.gswap) == \
            (b.kinds, b.midx, b.prologue, b.gswap)
        assert (a.relayout is None) == (b.relayout is None)
        if a.relayout is not None:
            assert np.array_equal(a.relayout, b.relayout)
    assert np.array_equal(plan.final_position, jplan.final_position)
    assert (plan.num_ops, plan.num_tswaps, plan.num_xswaps, plan.num_perms,
            plan.num_relayouts, plan.num_gswaps, plan.mono_as_mat) == \
        (jplan.num_ops, jplan.num_tswaps, jplan.num_xswaps, jplan.num_perms,
         jplan.num_relayouts, jplan.num_gswaps, jplan.mono_as_mat)


def _state(re, im):
    return join_shards(re, im)


@pytest.mark.parametrize("n,gates,seed", [(12, 300, 1), (13, 400, 5)])
def test_parity_segmented_8way(n, gates, seed):
    c = TM.grover_like(n, num_gates=gates, seed=seed)
    got = _simulate_segmented(c)
    assert np.max(np.abs(got - simulate_reference(c))) < TOL
    want = _jax_segmented(JM.grover_like(n, num_gates=gates, seed=seed))
    assert np.max(np.abs(got - want)) < TOL


def test_gswap_entries_planned_and_exact():
    """Gates on mesh-axis qubits force gswap entries, planned and packed as
    in the JAX package; each runs once a call (its launch count) and the
    amplitudes stay exact."""
    n = 12
    prog, jprog = _programs(n, 250, 9)
    _assert_same_plan(prog.plan, jprog.plan)
    assert prog.plan.num_gswaps > 0
    assert prog.chunk_sizes == jprog.chunk_sizes
    assert prog.mode_rows.get(4) == prog.plan.num_gswaps
    SP.gswap.launches = 0
    re, im = prog(*prog.init_state())
    assert SP.gswap.launches == prog.plan.num_gswaps
    want = simulate_reference(TM.grover_like(n, 250, 9))
    assert np.max(np.abs(_state(re, im) - want)) < TOL
    # the gswap is an entry of the sharded chain alone: the flat and the
    # in-place chains and the block kernels refuse scal mode 4
    from gpu_quantum_simulator_tpu_torch.kernels import block as KB

    for inplace in (False, True):
        entries = TPF.materialize_entries([TPF._Block(gswap=0)],
                                          TPF.CAP_STEPS, 2, np.float32,
                                          inplace=inplace)
        chain = TPF.program_from_entries(entries, n, "cpu", inplace=inplace)
        x = torch.zeros(1 << n)
        with pytest.raises(ValueError, match="sharded chain"):
            chain(x, x.clone()) if not inplace else chain(
                *(torch.zeros(1 << (n - 8), 128) for _ in range(4)))
    row = entries[0][2][0]
    with pytest.raises(ValueError, match="sharded chain"):
        KB.run_block(row, torch.zeros(16, 256), torch.zeros(16, 256),
                     None, None, None, 4, TPF.CAP_STEPS)


def test_recompile_free_across_circuits():
    """Programs are cached by circuit and mesh: a second circuit at the same
    (n, mesh) adds one program, a repeat run plans nothing."""
    n = 12
    c1 = TM.grover_like(n, num_gates=260, seed=11)
    c2 = TM.grover_like(n, num_gates=270, seed=12)
    SP._RUN_CACHE.clear()
    got1 = _simulate_segmented(c1)
    assert len(SP._RUN_CACHE) == 1
    got2 = _simulate_segmented(c2)
    assert len(SP._RUN_CACHE) == 2
    keys = list(SP._RUN_CACHE)
    assert all(k[0] == "shard" and k[5] == make_mesh(
        None, ("amp",), CPU8).key for k in keys)
    again = _simulate_segmented(c1)
    assert len(SP._RUN_CACHE) == 2 and np.array_equal(again, got1)
    assert np.max(np.abs(got1 - simulate_reference(c1))) < TOL
    assert np.max(np.abs(got2 - simulate_reference(c2))) < TOL


def test_deep_circuit_is_segmented():
    """The 2445-gate benchmark circuit runs as several bounded table parts,
    the JAX package's chunks."""
    n = 12
    prog, jprog = _programs(n, 2445, 318)
    assert prog.chunk_sizes == jprog.chunk_sizes
    assert len(prog.chunk_sizes) >= 2, prog.chunk_sizes
    assert max(prog.chunk_sizes) <= 512
    _assert_same_plan(prog.plan, jprog.plan)
    re, im = prog(*prog.init_state())
    want = simulate_reference(TM.grover_like(n, 2445, 318))
    assert np.max(np.abs(_state(re, im) - want)) < TOL


def test_initial_state_resume_segmented():
    n = 12
    c1 = TM.grover_like(n, num_gates=150, seed=21)
    c2 = TM.grover_like(n, num_gates=150, seed=22)
    sim = _sim()
    mid = sim.run(c1)
    got = sim.run(c2, initial=mid)
    merged = TM.grover_like(n, num_gates=150, seed=21)
    merged.gates.extend(c2.gates)
    assert np.max(np.abs(got - simulate_reference(merged))) < TOL


def test_n31_plan_smoke():
    """Plan a deep n=31 circuit over eight shards (nl = 28, the JAX
    package's scale target), planning only: gswaps and relayouts, bounded
    chunks, the JAX plan item for item, and no device tensor made."""
    n = 31
    ops = t_fuse(TM.grover_like(n, 400, 31), 7, max_high=2, window=8)
    jops = j_fuse(JM.grover_like(n, 400, 31), 7, max_high=2, window=8)
    prog = SP.ShardedPrefetchProgram(ops, n, make_mesh(None, ("amp",), CPU8),
                                     final_layout=np.arange(n))
    assert prog.plan.num_gswaps > 0
    assert prog.plan.num_relayouts > 0
    assert max(prog.chunk_sizes) <= 512
    jplan = JPF.plan_prefetch(jops, n, final_layout=np.arange(n),
                              num_global=3, allow_relayout=True)
    _assert_same_plan(prog.plan, jplan)
    assert all(isinstance(t, np.ndarray) for _, tabs in prog._chain._parts
               for t in tabs)


def test_run_device_iterated_segmented():
    prefix, body, iters = TM.grover_parts(9, marked=3, iterations=4)
    n = body.num_qubits  # 9 + 7 ancillas = 16 -> nl = 13 on 8 shards
    sim = _sim()
    assert sim._shard_segmented(n)
    re, im, _ = sim.run_device_iterated(body, 4, prefix=prefix)
    got = _state(re, im)
    ref = T.Simulator(T.SimulatorConfig(strategy="mxu"), device="cpu")
    re2, im2, _ = ref.run_device_iterated(body, 4, prefix=prefix)
    want = re2.numpy() + 1j * im2.numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("reload", [8, 2, 4], ids=["same", "onto2", "onto4"])
def test_sharded_checkpoint_roundtrip(tmp_path, reload):
    """Sharded checkpoint: saved mid-run shard by shard, reloaded bit for
    bit onto a mesh of any shard count, resumed through a layout-closed
    program: the one-shot run's amplitudes."""
    from gpu_quantum_simulator_tpu_torch.utils.checkpoint import (
        load_state_sharded, save_state_sharded)

    n = 12
    c1 = TM.grover_like(n, num_gates=150, seed=21)
    c2 = TM.grover_like(n, num_gates=150, seed=22)
    mesh = make_mesh(None, ("amp",), CPU8)
    ops1 = t_fuse(c1, 7, max_high=2, window=8)
    prog1 = SP.ShardedPrefetchProgram(ops1, n, mesh, final_layout=np.arange(n))
    re, im = prog1(*prog1.init_state())
    path = str(tmp_path / "ck")
    save_state_sharded(path, re, im, n, meta={"circuit": "c1"})

    target = make_mesh((reload,), ("amp",), CPU8)
    re2, im2, meta = load_state_sharded(path, mesh=target, axis="amp")
    assert meta["num_qubits"] == n and meta["circuit"] == "c1"
    assert len(re2) == reload
    assert torch.equal(torch.cat(re2), torch.cat(re))
    assert torch.equal(torch.cat(im2), torch.cat(im))
    flat_re, flat_im, _ = load_state_sharded(path)
    assert np.array_equal(flat_re, torch.cat(re).numpy())
    assert np.array_equal(flat_im, torch.cat(im).numpy())

    ops2 = t_fuse(c2, 7, max_high=2, window=8)
    prog2 = SP.ShardedPrefetchProgram(ops2, n, target,
                                      final_layout=np.arange(n))
    rea, ima = prog2(re2, im2)
    joint = Circuit(n, c1.gates + c2.gates)
    assert np.max(np.abs(_state(rea, ima) - simulate_reference(joint))) < TOL


def test_sharded_portfolio_parity(monkeypatch):
    """The lookahead-depth portfolio, priced with the gswap term, picks the
    model's minimum; every candidate's estimate equals the JAX package's
    float for float, and so does the pick."""
    n, d = 12, 3
    ops = t_fuse(TM.grover_like(n, 250, 23), 7, max_high=2, window=8)
    jops = j_fuse(JM.grover_like(n, 250, 23), 7, max_high=2, window=8)
    costs = []
    for waves in TPF.PLAN_PORTFOLIO:
        plan = SP.plan_prefetch(ops, n, final_layout=np.arange(n),
                                num_global=d, lookahead_waves=waves)
        jplan = JPF.plan_prefetch(jops, n, final_layout=np.arange(n),
                                  num_global=d, lookahead_waves=waves)
        _assert_same_plan(plan, jplan)
        costs.append(TPC.estimate_plan_sharded(plan, n, d)[0])
        assert TPC.estimate_plan_sharded(plan, n, d) == \
            JPC.estimate_plan_sharded(jplan, n, d)
    monkeypatch.setattr(TPF, "PORTFOLIO_MIN_QUBITS", n)
    prog = SP.ShardedPrefetchProgram(ops, n, make_mesh(None, ("amp",), CPU8),
                                     final_layout=np.arange(n))
    assert TPC.estimate_plan_sharded(prog.plan, n, d)[0] == min(costs)
    re, im = prog(*prog.init_state())
    want = simulate_reference(TM.grover_like(n, 250, 23))
    assert np.max(np.abs(_state(re, im) - want)) < TOL


def test_precision_high_sharded_parity():
    """precision='high' reaches every shard's mat step (the 3-pass bf16
    product's plain version): bf16-residual error, under TOL."""
    n = 12
    c = TM.grover_like(n, num_gates=300, seed=17)
    got = _simulate_segmented(c, precision="high")
    highest = _simulate_segmented(c, precision="highest")
    assert 0 < np.max(np.abs(got - highest))
    assert np.max(np.abs(got - simulate_reference(c))) < TOL


def test_deep_wide_register_dispatch_throttle(monkeypatch):
    """The deepest and widest case the suite runs here (n = 13, 400 gates)
    over enough table parts that the chain's periodic sync point is
    reached; parity with the reference."""
    monkeypatch.setattr(SP, "SYNC_PARTS", 1)
    monkeypatch.setattr(SP, "TABLE_GROUP", 3)
    n, gates = 13, 400
    c = TM.grover_like(n, num_gates=gates, seed=318)
    got = _simulate_segmented(c)
    assert np.max(np.abs(got - simulate_reference(c))) < TOL
