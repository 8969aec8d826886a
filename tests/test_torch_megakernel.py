"""The port's megakernel arm and its apply primitives against the JAX
package.

``ops/apply.py``'s ``apply_1q``, ``apply_2q``, ``apply_cnot`` and each of
``apply_kq``'s three arms on random normalized states, ``build_megakernel``
on the same fused ops, and ``Simulator(..., device="cpu")`` at the widths
every strategy sends through the megakernel arm, against the JAX
package's Simulator.  Both sides compute in float32 (the JAX package at
precision "highest", the port in IEEE fp32): sums run in another order, so
amplitudes agree to 1e-6 (the "highest" bar), not bit for bit.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine.megakernel import (
    build_megakernel as j_build_megakernel)
from gpu_quantum_simulator_tpu.engine.simulator import Simulator as JSimulator
from gpu_quantum_simulator_tpu.ops import apply as JA
from gpu_quantum_simulator_tpu.passes.fuse4x4 import fuse_4x4 as j_fuse_4x4
from gpu_quantum_simulator_tpu.passes.fuse_k import fuse_k as j_fuse_k

import torch

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch.engine import megakernel as TM
from gpu_quantum_simulator_tpu_torch.ops import apply as TA
from gpu_quantum_simulator_tpu_torch.passes.fuse4x4 import fuse_4x4
from gpu_quantum_simulator_tpu_torch.passes.fuse_k import fuse_k

AMP_TOL = 1e-6       # float32 sums in another order ("highest" bar)
STRATEGIES = ("mxu", "pallas", "prefetch", "vmem", "megakernel")


def _state(rng, n):
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    v /= np.linalg.norm(v)
    return v.real.astype(np.float32), v.imag.astype(np.float32)


def _unitary(rng, k):
    d = 1 << k
    q, r = np.linalg.qr(rng.standard_normal((d, d))
                        + 1j * rng.standard_normal((d, d)))
    u = q * (np.diag(r) / np.abs(np.diag(r)))
    return u.real.astype(np.float32), u.imag.astype(np.float32)


def _both(fn_name, rng, n, *args, mats=None):
    """Run the primitive of each package on one random state; max |diff|."""
    re, im = _state(rng, n)
    mats = () if mats is None else mats
    want = getattr(JA, fn_name)(jnp.asarray(re), jnp.asarray(im), *mats,
                                *args, n)
    got = getattr(TA, fn_name)(torch.from_numpy(re), torch.from_numpy(im),
                               *mats, *args, n)
    assert got[0].shape == (1 << n,) and got[0].dtype == torch.float32
    return max(float(np.max(np.abs(got[c].numpy() - np.asarray(want[c]))))
               for c in (0, 1))


@pytest.mark.parametrize("n", range(5, 11))
def test_apply_1q_matches_jax(n):
    rng = np.random.default_rng(n)
    k = int(rng.integers(n))
    assert _both("apply_1q", rng, n, k, mats=_unitary(rng, 1)) <= AMP_TOL


@pytest.mark.parametrize("n", range(5, 11))
def test_apply_2q_matches_jax(n):
    rng = np.random.default_rng(100 + n)
    qa, qb = (int(q) for q in rng.choice(n, 2, replace=False))
    assert _both("apply_2q", rng, n, qa, qb, mats=_unitary(rng, 2)) <= AMP_TOL


@pytest.mark.parametrize("n", range(5, 11))
def test_apply_cnot_matches_jax(n):
    """An index permutation: exact."""
    rng = np.random.default_rng(200 + n)
    for _ in range(3):
        c, t = (int(q) for q in rng.choice(n, 2, replace=False))
        assert _both("apply_cnot", rng, n, c, t) == 0.0


def _kq_qubits(arm, n, rng):
    if arm == "contiguous":
        a = int(rng.integers(n - 2))
        return (a, a + 1, a + 2)
    if arm == "wide":            # <= 3 qubits >= 7, not a contiguous run
        return (1, 4) + tuple(sorted(int(q) for q in rng.choice(
            range(7, n), min(2, n - 7), replace=False)))
    if n <= 7:                   # the general transpose: n <= 7 ...
        return (0, 2, n - 1)
    return (0, 7, 8, 9, 10)      # ... or more than 3 qubits >= 7


@pytest.mark.parametrize("arm,n", [("contiguous", n) for n in range(5, 11)]
                         + [("wide", n) for n in (8, 9, 10)]
                         + [("general", n) for n in (5, 6, 7, 11)])
def test_apply_kq_arms_match_jax(arm, n):
    rng = np.random.default_rng(300 + n)
    qubits = _kq_qubits(arm, n, rng)
    high = sum(q >= 7 for q in qubits)
    contiguous = qubits == tuple(range(qubits[0], qubits[0] + len(qubits)))
    assert contiguous == (arm == "contiguous")
    assert (arm == "wide") == (not contiguous and n > 7 and high <= 3)
    mats = _unitary(rng, len(qubits))
    assert _both("apply_kq", rng, n, qubits, mats=mats) <= AMP_TOL


def test_apply_kq_rejects_unsorted_qubits():
    re = torch.zeros(1 << 5)
    ur = np.eye(4, dtype=np.float32)
    with pytest.raises(ValueError, match="sorted"):
        TA.apply_kq(re, re, ur, 0 * ur, (3, 1), 5)


@pytest.mark.parametrize("n", [6, 8, 10])
def test_build_megakernel_matches_jax(n):
    """Each package fuses its own circuit to <= 4-qubit blocks (the same
    ops, tests/test_torch_plan.py); both megakernels run one state."""
    c = T.models.grover_like(n, 150, 40 + n)
    jc = JM.grover_like(n, 150, 40 + n)
    ops = fuse_k(fuse_4x4(c), max_qubits=4)
    jops = j_fuse_k(j_fuse_4x4(jc), max_qubits=4)
    assert len(ops) == len(jops)
    assert {len(op.qubits) for op in ops} >= {3, 4}      # apply_kq runs
    re, im = _state(np.random.default_rng(n), n)
    got = TM.build_megakernel(ops, n, device="cpu")(
        torch.from_numpy(re), torch.from_numpy(im))
    assert TM.build_megakernel(ops, n, device="cpu") is \
        TM.build_megakernel(ops, n, device="cpu")      # cached
    want = j_build_megakernel(jops, n)(jnp.asarray(re), jnp.asarray(im))
    err = max(float(np.max(np.abs(got[i].numpy() - np.asarray(want[i]))))
              for i in (0, 1))
    assert err <= AMP_TOL


@pytest.mark.parametrize("strategy,n",
                         [(s, n) for s in STRATEGIES for n in range(2, 9)]
                         + [("megakernel", 12)])
def test_small_widths_match_jax(strategy, n):
    """Every strategy's megakernel arm (mxu, pallas, vmem at n <= 7,
    prefetch at n < 9) and the engines just above it, against the JAX
    Simulator: the same fused-op count, amplitudes within 1e-6."""
    c = T.models.grover_like(n, 120, n)
    got = T.Simulator(T.SimulatorConfig(strategy=strategy),
                      device="cpu").run_detailed(c)
    want = JSimulator(JConfig(strategy=strategy)).run_detailed(
        JM.grover_like(n, 120, n))
    assert got.state.shape == (1 << n,) and got.state.dtype == np.complex64
    assert got.num_fused_ops == want.num_fused_ops
    assert np.max(np.abs(got.state - want.state)) <= AMP_TOL
