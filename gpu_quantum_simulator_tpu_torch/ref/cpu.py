"""Double-precision CPU reference simulator and host-side sampling, numpy.

A JAX-free copy of ``gpu_quantum_simulator_tpu/ref/cpu.py``: the
complex128 gate-by-gate simulator (``strategy="reference"``, the
semantics of the reference CPU program quantum_simulator.c) and the
inverse-CDF sampler.  With the same ``np.random.default_rng(seed)`` both
packages draw the same samples, bit for bit.  The Simulator samples here up
to n = 22; wider states are sampled on the device (sampling.py).  Nothing
here touches a device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ir.circuit import Circuit, Gate


def initial_state(num_qubits: int, dtype=np.complex128) -> np.ndarray:
    v = np.zeros(1 << num_qubits, dtype=dtype)
    v[0] = 1.0
    return v


def apply_gate_numpy(v: np.ndarray, num_qubits: int, gate: Gate) -> np.ndarray:
    """Apply one gate to flat state v (little-endian qubit k = bit k)."""
    if gate.is_cx:
        return _apply_cnot(v, num_qubits, *gate.qubits)
    return _apply_1q(v, num_qubits, gate.matrix().astype(v.dtype), gate.qubits[0])


def _apply_1q(v: np.ndarray, n: int, u: np.ndarray, k: int) -> np.ndarray:
    # bit k is the middle axis of (high, 2, low) with low = 2^k fast-varying
    v3 = v.reshape(1 << (n - k - 1), 2, 1 << k)
    return np.einsum("ab,xbz->xaz", u, v3).reshape(-1)


def _apply_cnot(v: np.ndarray, n: int, control: int, target: int) -> np.ndarray:
    # Swap target-pair amplitudes where the control bit is set
    # (ref: quantum_simulator.c:94-106).
    out = v.copy()
    idx = np.arange(1 << n)
    sel = (idx >> control) & 1 == 1
    out[idx[sel]] = v[idx[sel] ^ (1 << target)]
    return out


def simulate_reference(
    circuit: Circuit,
    dtype=np.complex128,
    initial: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Run the circuit gate by gate; returns the final 2^n state vector."""
    n = circuit.num_qubits
    v = initial_state(n, dtype) if initial is None else initial.astype(dtype)
    if v.shape != (1 << n,):
        raise ValueError("initial state has wrong length")
    for g in circuit.gates:
        v = apply_gate_numpy(v, n, g)
    return v


def cumulative_distribution(v: np.ndarray) -> np.ndarray:
    """Inclusive prefix sum of |amp|^2 (ref: quantum_simulator.c:256-268)."""
    return np.cumsum(np.abs(v) ** 2)


def sample(
    v: np.ndarray,
    num_samples: int,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Inverse-CDF measurement sampling (ref: quantum_simulator.c:270-283).

    Returns int64 basis-state indices.  The reference walks the cumulative
    array linearly and skips zero-probability prefixes; searchsorted with
    side='left' on u in (0,1] is equivalent.
    """
    rng = rng or np.random.default_rng()
    cumul = cumulative_distribution(v)
    total = cumul[-1]
    u = rng.uniform(0.0, total, size=num_samples)
    return np.searchsorted(cumul, u, side="left").astype(np.int64)
