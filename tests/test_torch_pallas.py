"""The port's ``pallas`` strategy against the JAX package.

The low-region plan (``plan_sharded``) item for item, kernel 9's plain
version against the JAX ``apply_block128`` in interpret mode, the swap
copy, amplitudes of ``Simulator(strategy="pallas", device="cpu")``
against the JAX package's pallas Simulator, the rung it ignores, and the
fences of the slice.  Each test states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine.simulator import Simulator as JSimulator
from gpu_quantum_simulator_tpu.ir.circuit import Circuit as JCircuit
from gpu_quantum_simulator_tpu.ops import pallas_kernels as PK
from gpu_quantum_simulator_tpu.passes import shard as JSH
from gpu_quantum_simulator_tpu.passes.fuse4x4 import fuse_4x4 as j_fuse_4x4
from gpu_quantum_simulator_tpu.passes.fuse_k import fuse_k as j_fuse_k

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch.engine import pallas_engine as TP
from gpu_quantum_simulator_tpu_torch.ir.oplist import Op
from gpu_quantum_simulator_tpu_torch.kernels import wide as KW
from gpu_quantum_simulator_tpu_torch.passes import shard as TSH
from gpu_quantum_simulator_tpu_torch.passes.fuse4x4 import fuse_4x4
from gpu_quantum_simulator_tpu_torch.passes.fuse_k import fuse_k

from test_torch_wide import KARATSUBA_TOL, low_only

AMP_TOL = 1e-6       # "highest" amplitudes (BASELINE.md bar)
MAT_TOL = 1e-12      # fused matrices: the same f64 products


def _assert_same_plan(got, want):
    assert len(got.items) == len(want.items)
    for a, b in zip(got.items, want.items):
        assert type(a).__name__ == type(b).__name__
        if isinstance(b, JSH.SwapItem):
            assert (a.pos_a, a.pos_b) == (b.pos_a, b.pos_b)
        else:
            assert a.kind == b.kind and tuple(a.qubits) == tuple(b.qubits)
            if b.u is not None:
                assert np.max(np.abs(a.u - np.asarray(b.u))) <= MAT_TOL
    assert np.array_equal(got.final_position, want.final_position)
    assert got.num_swaps == want.num_swaps
    assert want.num_local_swaps == 0


def _family(models, circuit, family, n):
    if family == "grover":
        return models.grover_like(n, 400, n)
    if family == "random":
        return models.random_circuit(n, 300, seed=n)
    if family == "ghz":
        return models.ghz(n)
    return low_only(circuit, n, 300)


@pytest.mark.parametrize("family", ["grover", "random", "ghz", "low_only"])
@pytest.mark.parametrize("n,d", [(10, 3), (12, 5), (14, 7)])
def test_plan_sharded_matches_jax(n, d, family):
    """Each package fuses its own circuit (fuse_k(fuse_4x4(c), 7)) and plans
    it with d global qubits under the JAX planner's defaults (the arm the
    pallas engine runs): the same items, layout and counts."""
    tc = _family(T.models, T.Circuit, family, n)
    jc = _family(JM, JCircuit, family, n)
    k = min(7, n - d)
    ops = fuse_k(fuse_4x4(tc), max_qubits=k)
    jops = j_fuse_k(j_fuse_4x4(jc), max_qubits=k)
    _assert_same_plan(TSH.plan_sharded(ops, n, d),
                      JSH.plan_sharded(jops, n, d))


def test_carried_ops_plan_like_jax():
    """The JAX package's fused ops, rebuilt as the port's Op, plan the same
    (the pallas engine's d = n - 7)."""
    n = 12
    jops = j_fuse_k(j_fuse_4x4(JM.grover_like(n, 500, 2)), max_qubits=7)
    ops = [Op(o.kind, tuple(int(q) for q in o.qubits),
              None if o.u is None else np.asarray(o.u)) for o in jops]
    _assert_same_plan(TSH.plan_sharded(ops, n, n - 7),
                      JSH.plan_sharded(jops, n, n - 7))


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_block128_plain_matches_jax_kernel(seed):
    """apply_block128_plain (Karatsuba, IEEE fp32) against the JAX kernel 9
    in interpret mode (Karatsuba at HIGHEST, its combinations formed from
    the same fp32 matrices) on a normalized state, to KARATSUBA_TOL, which
    the schoolbook product misses; the wrapper takes the plain version for
    CPU tensors."""
    rng = np.random.default_rng(seed)
    R = 64
    v = rng.standard_normal((2, R, 128))
    v = (v / np.linalg.norm(v)).astype(np.float32)
    q, r = np.linalg.qr(rng.standard_normal((128, 128))
                        + 1j * rng.standard_normal((128, 128)))
    u = q * (np.diag(r) / np.abs(np.diag(r)))
    m_re = torch.from_numpy(u.real.astype(np.float32))
    m_im = torch.from_numpy(u.imag.astype(np.float32))
    re, im = torch.from_numpy(v[0]), torch.from_numpy(v[1])
    got = KW.apply_block128_plain(re, im, m_re, m_im)
    want = PK.apply_block128(jnp.asarray(v[0]), jnp.asarray(v[1]),
                             jnp.asarray(m_re.numpy()),
                             jnp.asarray(m_im.numpy()), tile_rows=32,
                             interpret=True)
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= KARATSUBA_TOL
    school = (re @ m_re.T - im @ m_im.T, re @ m_im.T + im @ m_re.T)
    assert max(np.max(np.abs(g.numpy() - np.asarray(w)))
               for g, w in zip(school, want)) > KARATSUBA_TOL
    KW.reset_launches()
    out = (re.clone(), im.clone())
    wrapped = KW.apply_block128(*out, m_re, m_im, out=out)
    assert wrapped[0] is out[0]
    assert torch.equal(wrapped[0], got[0]) and torch.equal(wrapped[1], got[1])
    assert KW.apply_block128.launches == 0


@pytest.mark.parametrize("low,qubit", [(0, 7), (3, 9), (6, 11)])
def test_swap_low_high_matches_jax(low, qubit):
    n = 12
    v = np.random.default_rng(qubit).standard_normal((2, 1 << (n - 7), 128))
    v = v.astype(np.float32)
    got = TP.swap_low_high(torch.from_numpy(v[0]), torch.from_numpy(v[1]),
                           low, qubit, n)
    want = PK.swap_low_high(jnp.asarray(v[0]), jnp.asarray(v[1]), low,
                            qubit, n)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _pallas(**kw):
    return T.Simulator(T.SimulatorConfig(strategy="pallas", **kw),
                       device="cpu")


@pytest.mark.parametrize("case", ["grover", "low_only_k3"])
def test_pallas_amplitudes_match_jax(case):
    """Simulator(strategy="pallas") of both packages: the same item count
    and amplitudes to 1e-6; the program holds one table per mat item."""
    if case == "grover":
        tc, jc, kw = (T.models.grover_like(10, 300, 9),
                      JM.grover_like(10, 300, 9), {})
    else:
        tc, jc, kw = (low_only(T.Circuit, 10, 600),
                      low_only(JCircuit, 10, 600), {"max_fused_qubits": 3})
    TP._CACHE.clear()
    got = _pallas(**kw).run_detailed(tc)
    want = JSimulator(JConfig(strategy="pallas", **kw)).run_detailed(jc)
    assert got.num_fused_ops == want.num_fused_ops
    assert np.max(np.abs(got.state - np.asarray(want.state))) <= AMP_TOL
    (prog, _, num_items), = TP._CACHE.values()
    assert num_items == got.num_fused_ops == prog.num_mats + prog.num_swaps
    assert prog.num_mats > 0


def test_pallas_ignores_the_rung():
    """Every mat item is IEEE fp32 whatever ``precision`` says, as in the
    JAX package: the same state bit for bit under every rung."""
    c = T.models.grover_like(11, 300, 4)
    ref = _pallas(precision="highest").run(c)
    for rung in ("high", "auto", "default"):
        assert np.array_equal(_pallas(precision=rung).run(c), ref)


def test_pallas_initial_state_and_permute():
    """Resuming from a prefix's state equals the whole circuit; the
    relabeling and the planner's residual layout are both undone."""
    n = 10
    full = T.models.grover_like(n, 200, 31)
    first, second = T.Circuit(n), T.Circuit(n)
    first.gates = full.gates[:100]
    second.gates = full.gates[100:]
    sim = _pallas()
    got = sim.run(second, initial=sim.run(first))
    want = np.asarray(JSimulator(JConfig(strategy="pallas")).run(
        JM.grover_like(n, 200, 31)))
    assert np.max(np.abs(got - want)) <= 2 * AMP_TOL
    perm = _pallas(permute=True).run(full)
    assert np.max(np.abs(perm - want)) <= AMP_TOL


@pytest.mark.parametrize("kind,exc", [
    ("n7", ValueError), ("n31", ValueError),
    ("complex128", ValueError),
])
def test_pallas_faults_raise(kind, exc):
    # complex128 is refused at every width, the megakernel arm of n = 7
    # included: the engine's kernels are float32-only (the JAX package's
    # Mosaic kernels run no float64 on the chip), and the message names
    # the float64 arms
    n = {"n7": 7, "n31": 31}.get(kind, 10)
    kw = {"complex128": dict(dtype="complex128"),
          "n7": dict(dtype="complex128")}.get(kind, {})
    c = T.Circuit(n)
    c.h(0)
    TP._CACHE.clear()
    with pytest.raises(exc, match="ceiling|float32-only"):
        _pallas(**kw).run(c)
    assert not TP._CACHE
