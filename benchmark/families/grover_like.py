"""The sweep circuit family: random circuits with grover_3_18.qasm's gate mix.

A frozen copy of ``random_circuit`` and ``GROVER_3_18_PROFILE`` from
``gpu_quantum_simulator_tpu_torch/models/circuits.py`` (itself the JAX
package's generator), returning plain gate lists: ``(name, qubits, params)``
tuples with ``qubits`` ``(target,)`` or ``(control, target)`` and ``params``
``(theta,)`` for ``rz``, else ``()``.  The benchmark's tests hold it to the
original gate for gate; later edits there do not move the benchmark.

``gates(config, entropy)`` is what a cell runs.  With an integer
``structure_seed`` in the configuration it is the gate structure (names and
qubits) of ``grover_like(num_qubits, num_gates, structure_seed)``, drawn
once, with every ``rz`` angle drawn anew from ``entropy``: a parameter
sweep over one circuit, so every seed asks for the same fused steps and
runs do the same work; the answers differ per seed.  With
``structure_seed`` null every request gets a structure of its own, drawn
whole from ``entropy`` (random-circuit sampling); such structures plan up
to 9% more or less work at n = 28 and 30.
"""

from __future__ import annotations

import math

import numpy as np

# Gate mix of grover_3_18.qasm: 1024 cx / 1212 rz / 174 sx / 35 x.
GROVER_3_18_PROFILE = {
    "cx": 1024 / 2445,
    "rz": 1212 / 2445,
    "sx": 174 / 2445,
    "x": 35 / 2445,
}


def random_circuit(num_qubits: int, num_gates: int, seed: int, profile):
    """The original generator's draws, in its order, as a gate list."""
    if num_qubits < 2:
        raise ValueError("need >= 2 qubits (cx requires a pair)")
    names = sorted(profile)
    weights = np.array([profile[k] for k in names], dtype=np.float64)
    weights /= weights.sum()
    rng = np.random.default_rng(seed)
    gates = []
    picks = rng.choice(len(names), size=num_gates, p=weights)
    for pick in picks:
        name = names[pick]
        if name == "cx":
            a, b = rng.choice(num_qubits, size=2, replace=False)
            gates.append(("cx", (int(a), int(b)), ()))
        elif name == "rz":
            theta = float(rng.uniform(-2 * math.pi, 2 * math.pi))
            gates.append(("rz", (int(rng.integers(num_qubits)),), (theta,)))
        else:
            gates.append((name, (int(rng.integers(num_qubits)),), ()))
    return gates


def grover_like(num_qubits: int, num_gates: int = 2445, seed: int = 318):
    return random_circuit(num_qubits, num_gates, seed, GROVER_3_18_PROFILE)


def gates(config: dict, entropy):
    """The gate list of one request: ``config``'s ``num_qubits``,
    ``num_gates`` and ``structure_seed``; ``entropy`` a list of whole
    numbers >= 0 (the run's seed and the request's tags)."""
    n, count = config["num_qubits"], config["num_gates"]
    if config["structure_seed"] is None:
        return grover_like(n, count, list(entropy))
    rng = np.random.default_rng(list(entropy))
    out = []
    for name, qubits, params in grover_like(n, count,
                                            config["structure_seed"]):
        if name == "rz":
            params = (float(rng.uniform(-2 * math.pi, 2 * math.pi)),)
        out.append((name, qubits, params))
    return out
