"""Zero-noise extrapolation (ZNE) over the trajectory noise stack.

The JAX package's ``mitigation.py`` copied (host numpy); its noisy
expectations come from the port's ``dynamic.expectation_noisy``.

Error mitigation for noisy expectation values — a capability the CUDA
reference (pure states only, quantum_simulator.c) has no analog of, and
the natural consumer of two existing pieces:

* **Unitary folding** (:func:`folded`) scales the effective noise by an
  odd integer c: the circuit becomes C (C^dagger C)^((c-1)/2) — the same
  unitary, c times the gates, hence ~c times the per-gate noise.  Exact
  by ``Circuit.inverse`` (the gate set is dagger-closed).
* **Trajectory ensembles** (``dynamic.expectation_noisy``) evaluate each
  folded circuit under the per-gate noise model as ONE batched device
  ensemble with shared seeds across scales (common-random-numbers
  variance reduction on the extrapolation differences).

:func:`zne_expectation` fits a polynomial in the scale and reads off the
value at c = 0.  With order=1 (default) this is classic Richardson/linear
ZNE; order=len(scales)-1 gives full Richardson extrapolation.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .config import SimulatorConfig
from .ir.circuit import Circuit


def folded(circuit: Circuit, scale: int) -> Circuit:
    """Global unitary folding: C -> C (C^dagger C)^((scale-1)/2).

    ``scale`` must be a positive odd integer; the returned circuit
    implements the SAME unitary with ``scale``x the gate count, so a
    per-gate noise model acts ~``scale``x as often."""
    scale = int(scale)
    if scale < 1 or scale % 2 == 0:
        raise ValueError(f"fold scale must be a positive odd integer, "
                         f"got {scale}")
    out = Circuit(circuit.num_qubits, list(circuit.gates))
    inv = circuit.inverse()
    for _ in range((scale - 1) // 2):
        out.gates.extend(inv.gates)
        out.gates.extend(circuit.gates)
    return out


def zne_expectation(
    circuit: Circuit,
    terms,
    shots: int = 2048,
    kind: str = "depolarizing",
    p1: float = 0.0,
    p2: float = 0.0,
    seed: int = 0,
    scales: Sequence[int] = (1, 3, 5),
    order: int = 1,
    config: Optional[SimulatorConfig] = None,
    return_fits: bool = False,
    device="cuda",
):
    """Zero-noise-extrapolated <H> under a per-gate noise model.

    Evaluates ``expectation_noisy`` on the circuit folded at each scale
    (same seed: shared noise realizations) and extrapolates the values
    to scale 0 with a degree-``order`` polynomial fit.  Returns the
    mitigated float, or ``(value, scales, raw_values)`` when
    ``return_fits`` — the raw ladder is the honesty check.  The ensembles
    run on ``device`` (the card unless ``device="cpu"``).
    """
    from .dynamic import expectation_noisy

    scales = [int(c) for c in scales]
    if len(scales) < order + 1:
        raise ValueError(
            f"need at least order+1 = {order + 1} scales, got {len(scales)}")
    values = []
    for c in scales:
        fc = folded(circuit, c)
        values.append(expectation_noisy(
            fc, terms, shots=shots, kind=kind, p1=p1, p2=p2, seed=seed,
            config=config, device=device))
    coeffs = np.polyfit(np.asarray(scales, dtype=float),
                        np.asarray(values, dtype=float), order)
    value = float(np.polyval(coeffs, 0.0))
    if return_fits:
        return value, list(scales), [float(v) for v in values]
    return value


# ------------------------------------------------------------- readout
def readout_confusion_1q(p01: float, p10: Optional[float] = None):
    """Per-qubit confusion matrix A with A[m, t] = P(measure m | true t):
    ``p01`` = P(read 1 | true 0), ``p10`` = P(read 0 | true 1)
    (defaults to ``p01`` — the symmetric-flip model the noisy sampler
    implements)."""
    if p10 is None:
        p10 = p01
    if not (0.0 <= p01 < 0.5 and 0.0 <= p10 < 0.5):
        raise ValueError("readout flip probabilities must lie in [0, 0.5)")
    return np.array([[1.0 - p01, p10], [p01, 1.0 - p10]], dtype=np.float64)


def mitigate_readout(samples_or_counts, num_qubits: int, p01,
                     p10=None) -> np.ndarray:
    """Invert independent per-qubit readout error on measured outcomes.

    ``samples_or_counts``: an int sample array (``Simulator.sample`` /
    ``sample_noisy`` output) or a ``{basis_index_or_bitstring: count}``
    dict.  ``p01``/``p10``: scalars or per-qubit sequences (``p10`` None =
    symmetric).  Returns the length-2^n QUASI-probability vector — the
    tensor-product inverse confusion applied axis by axis; small negative
    entries are the standard signature of finite shots.  n is capped at
    20 (the vector is dense host-side)."""
    if num_qubits > 20:
        raise ValueError("mitigate_readout materializes 2^n host floats: "
                         f"n <= 20 (got {num_qubits})")
    size = 1 << num_qubits
    p = np.zeros(size, dtype=np.float64)
    if isinstance(samples_or_counts, dict):
        for key, cnt in samples_or_counts.items():
            idx = int(key, 2) if isinstance(key, str) else int(key)
            p[idx] += cnt
    else:
        arr = np.asarray(samples_or_counts, dtype=np.int64)
        np.add.at(p, arr, 1.0)
    total = p.sum()
    if total <= 0:
        raise ValueError("no samples to mitigate")
    p /= total

    p01v = np.broadcast_to(np.asarray(p01, dtype=np.float64),
                           (num_qubits,))
    p10v = (p01v if p10 is None else
            np.broadcast_to(np.asarray(p10, dtype=np.float64),
                            (num_qubits,)))
    for q in range(num_qubits):
        inv = np.linalg.inv(readout_confusion_1q(float(p01v[q]),
                                                 float(p10v[q])))
        # contract the 2x2 inverse along bit q of the basis index
        v = p.reshape(-1, 2, 1 << q)           # (high, bit q, low)
        p = np.einsum("mt,htl->hml", inv, v).reshape(size)
    return p


def mitigate_readout_expectation_z(value: float, num_z: int,
                                   p: float) -> float:
    """Exact inverse for a Z-string expectation under SYMMETRIC readout
    flips: each measured qubit attenuates <Z...Z> by (1 - 2p), so the
    mitigated value is ``value / (1 - 2p)^num_z``."""
    if not 0.0 <= p < 0.5:
        raise ValueError("readout flip probability must lie in [0, 0.5)")
    scale = (1.0 - 2.0 * p) ** int(num_z)
    return float(value) / scale
