"""The port's ``vmem`` strategy against the JAX package.

The same numpy-seeded inputs go through the JAX package's
``build_vmem_program(..., interpret=True)`` (as tests/test_vmem.py runs it)
and the port's ``build_vmem_program(..., device="cpu")`` (kernel 8's plain
version: torch row shuffles and four real fp32 matmuls per op).  Each
package fuses its own circuit (the same ops, tests/test_torch_plan.py).
Tolerances: 1e-5 between the packages (float32 sums in another order) and
2e-5 against the f64 reference (tests/test_vmem.py's TOL).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine import vmem as JV
from gpu_quantum_simulator_tpu.engine.simulator import Simulator as JSimulator
from gpu_quantum_simulator_tpu.ir.circuit import Circuit as JCircuit
from gpu_quantum_simulator_tpu.ir.oplist import Op as JOp
from gpu_quantum_simulator_tpu.passes.fuse4x4 import fuse_4x4 as j_fuse_4x4
from gpu_quantum_simulator_tpu.passes.fuse_k import fuse_k as j_fuse_k
from gpu_quantum_simulator_tpu.ref.cpu import simulate_reference

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch.engine import simulator as TS
from gpu_quantum_simulator_tpu_torch.engine import vmem as TV
from gpu_quantum_simulator_tpu_torch.ir.oplist import Op
from gpu_quantum_simulator_tpu_torch.kernels import vmem as KV
from gpu_quantum_simulator_tpu_torch.passes.fuse4x4 import fuse_4x4
from gpu_quantum_simulator_tpu_torch.passes.fuse_k import fuse_k
from gpu_quantum_simulator_tpu_torch.ref.native import simulate_native

JAX_TOL = 1e-5
REF_TOL = 2e-5


def _kh2_circuit(cls):
    """tests/test_vmem.py:40-49: blocks that keep two high (row) qubits."""
    c = cls(10)
    for i in range(12):
        c.cx(9, 8).rz(0.2 * i + 0.1, 9).h(8).cx(8, 7).t(7)
    return c


def _case(name):
    if name == "kh2":
        return _kh2_circuit(T.Circuit), _kh2_circuit(JCircuit), 96
    n, gates, seed, chunk = {"seed0": (9, 150, 0, 96),
                             "seed1": (9, 150, 1, 96),
                             "chunks3": (10, 300, 5, 3)}[name]
    return (T.models.random_circuit(n, gates, seed=seed),
            JM.random_circuit(n, gates, seed=seed), chunk)


@pytest.mark.parametrize("name", ["seed0", "seed1", "chunks3", "kh2"])
def test_vmem_program_matches_jax(name):
    c, jc, chunk = _case(name)
    n = c.num_qubits
    ops = fuse_k(fuse_4x4(c), max_qubits=min(7, n), max_high=2)
    jops = j_fuse_k(j_fuse_4x4(jc), max_qubits=min(7, n), max_high=2)
    assert len(ops) == len(jops)
    if name == "kh2":
        assert any(sum(q >= 7 for q in op.qubits) == 2 for op in ops)
    rng = np.random.default_rng(len(ops))
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    v /= np.linalg.norm(v)
    re, im = v.real.astype(np.float32), v.imag.astype(np.float32)

    prog = TV.build_vmem_program(ops, n, device="cpu", chunk_ops=chunk)
    assert len(prog.chunks) == math.ceil(len(ops) / chunk)
    got = prog(torch.from_numpy(re.copy()), torch.from_numpy(im.copy()))
    got = got[0].numpy() + 1j * got[1].numpy()
    jfn = JV.build_vmem_program(jops, n, interpret=True, chunk_ops=chunk)
    want = jfn(jnp.asarray(re), jnp.asarray(im))
    want = np.asarray(want[0]) + 1j * np.asarray(want[1])
    assert np.max(np.abs(got - want)) <= JAX_TOL
    assert np.max(np.abs(got - simulate_reference(jc, initial=v))) <= REF_TOL


def test_vmem_rejects_deep_high():
    u = np.eye(8, dtype=np.complex128)
    with pytest.raises(ValueError, match="2 high"):
        JV.build_vmem_program([JOp("u", (7, 8, 9), u)], 10, interpret=True)
    with pytest.raises(ValueError, match="2 high"):
        TV.build_vmem_program([Op("u", (7, 8, 9), u)], 10, device="cpu")


@pytest.mark.parametrize("n", [8, 10, 12])
def test_vmem_simulator_matches_jax(n):
    c = T.models.grover_like(n, 400, 7)
    got = T.Simulator(T.SimulatorConfig(strategy="vmem"),
                      device="cpu").run_detailed(c)
    want = JSimulator(JConfig(strategy="vmem")).run_detailed(
        JM.grover_like(n, 400, 7))
    assert got.num_fused_ops == want.num_fused_ops
    assert np.max(np.abs(got.state - want.state)) <= JAX_TOL
    assert np.max(np.abs(got.state - simulate_native(c))) <= REF_TOL


def test_vmem_above_19_raises():
    c = T.models.grover_like(20, 40, 1)
    TS._MXU_PLAN_CACHE.clear()
    with pytest.raises(ValueError, match="n <= 19"):
        T.Simulator(T.SimulatorConfig(strategy="vmem"), device="cpu").run(c)
    assert not TS._MXU_PLAN_CACHE          # nothing was planned or built
    with pytest.raises(ValueError, match="n <= 19"):
        TV.build_vmem_program([], 20, device="cpu")


def test_chunks_per_run():
    """The Simulator's plan: ceil(ops / 96) chunks, one launch each on the
    card (n = 8: 118 ops of the 2445-gate benchmark circuit, 2 chunks)."""
    n = 8
    c = T.models.grover_like(n, 2445, 318)
    TS._MXU_PLAN_CACHE.clear()
    res = T.Simulator(T.SimulatorConfig(strategy="vmem"),
                      device="cpu").run_detailed(c)
    (ops, prog), = TS._MXU_PLAN_CACHE.values()
    assert res.num_fused_ops == len(ops) == prog.num_ops == 118
    assert len(prog.chunks) == math.ceil(len(ops) / TV.CHUNK_OPS) == 2
    assert sum(len(ch.steps) for ch in prog.chunks) == len(ops)
    assert prog.ops_by_D == {128: 19, 256: 99}
    assert np.max(np.abs(res.state - simulate_native(c))) <= REF_TOL
    TS._MXU_PLAN_CACHE.clear()


def test_tables_layout():
    """desc rows (kh, b1, b2, offset) and Mt = M^T in the flat table."""
    rng = np.random.default_rng(3)
    specs = [((), rng.standard_normal((128, 128)),
              rng.standard_normal((128, 128))),
             ((2, 5), rng.standard_normal((512, 512)),
              rng.standard_normal((512, 512))),
             ((1,), rng.standard_normal((256, 256)),
              rng.standard_normal((256, 256)))]
    tab = KV.vmem_tables(specs, 12, "cpu")
    offs = [0, 2 * 128 ** 2, 2 * 128 ** 2 + 2 * 512 ** 2]
    assert tab.desc.tolist() == [[0, 0, 0, offs[0]], [2, 2, 5, offs[1]],
                                 [1, 1, 0, offs[2]]]
    for (row_bits, bre, bim), off, (rb, o, D) in zip(specs, offs, tab.steps):
        assert (rb, o, D) == (row_bits, off, bre.shape[0])
        mt = tab.mats[off : off + 2 * D * D].view(2, D, D).numpy()
        assert np.array_equal(mt[0], bre.T.astype(np.float32))
        assert np.array_equal(mt[1], bim.T.astype(np.float32))
    # an op has ceil(P / 32) x (D / 64) tiles of the kernel, P = 2^n / D
    # view rows: 1 x 2, 1 x 8 and 1 x 4 here (2^n / 2048 once P >= 32)
    assert tab.max_tiles == 8
    assert KV.vmem_tables(specs, 18, "cpu").max_tiles == (1 << 18) // 2048


def test_vmem_chunk_refuses_other_devices():
    tab = KV.vmem_tables([((), np.eye(128), np.zeros((128, 128)))], 8, "cpu")
    re = torch.zeros(2, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        KV.vmem_chunk(re, re, tab)
