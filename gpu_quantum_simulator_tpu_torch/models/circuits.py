"""Circuit families ("models") for tests and benchmarks (the slice's
subset: bell, ghz and the grover_like benchmark family).

The reference benchmarks over uncommitted random circuits
(``random_circs_ad/random_<n>.qasm``, tester.bash:12) plus two committed
workloads: ``entanglement.qasm`` (Bell) and ``grover_3_18.qasm`` (6 qubits,
2445 gates: 1024 cx / 1212 rz / 174 sx / 35 x).  ``random_circuit`` here
regenerates that distribution reproducibly; ``grover_like`` uses exactly the
grover_3_18 gate mix so sweeps are comparable across qubit counts.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from ..ir.circuit import Circuit

# Gate mix of grover_3_18.qasm (counted from the committed file; SURVEY §2.2).
GROVER_3_18_PROFILE: Dict[str, float] = {
    "cx": 1024 / 2445,
    "rz": 1212 / 2445,
    "sx": 174 / 2445,
    "x": 35 / 2445,
}

# A flat mix over the full reference gate set, for randomized parity tests.
FULL_PROFILE: Dict[str, float] = {
    name: 1.0 for name in ("cx", "x", "sx", "z", "s", "sdg", "t", "tdg", "rz", "h")
}


def bell() -> Circuit:
    """The committed entanglement.qasm workload: H(0); CX(0,1)."""
    return Circuit(2).h(0).cx(0, 1)


def ghz(n: int) -> Circuit:
    c = Circuit(n).h(0)
    for q in range(1, n):
        c.cx(q - 1, q)
    return c


def random_circuit(
    num_qubits: int,
    num_gates: int,
    seed: int = 0,
    profile: Optional[Dict[str, float]] = None,
) -> Circuit:
    """Random circuit in the reference gate set with a given gate-name mix."""
    if num_qubits < 2:
        raise ValueError("need >= 2 qubits (cx requires a pair)")
    profile = profile or FULL_PROFILE
    names = sorted(profile)
    weights = np.array([profile[k] for k in names], dtype=np.float64)
    weights /= weights.sum()
    rng = np.random.default_rng(seed)
    c = Circuit(num_qubits)
    picks = rng.choice(len(names), size=num_gates, p=weights)
    for pick in picks:
        name = names[pick]
        if name == "cx":
            a, b = rng.choice(num_qubits, size=2, replace=False)
            c.cx(int(a), int(b))
        elif name == "rz":
            c.rz(float(rng.uniform(-2 * math.pi, 2 * math.pi)), int(rng.integers(num_qubits)))
        else:
            c.append(name, int(rng.integers(num_qubits)))
    return c


def grover_like(num_qubits: int, num_gates: int = 2445, seed: int = 318) -> Circuit:
    """Random circuit with grover_3_18.qasm's exact gate mix.

    This is the benchmark workload family: the reference's sweep circuits are
    not committed, so we regenerate deterministic circuits with the same
    depth/mix as its deepest committed workload.
    """
    return random_circuit(num_qubits, num_gates, seed=seed, profile=GROVER_3_18_PROFILE)
