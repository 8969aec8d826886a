"""Classical shadows: estimate many local observables from randomized
Pauli-basis measurements (Huang-Kueng-Preskill).

The port of ``gpu_quantum_simulator_tpu/shadows.py``.  S snapshots, each
measuring every qubit in a uniformly random X/Y/Z basis, estimate EVERY
k-local Pauli simultaneously with variance ~3^k/S — the shot-frugal
alternative to per-observable measurement when the observable list is
long.

On the device: the circuit runs ONCE; snapshots differ only in their
basis rotations, so a chunk of S' members is the state tiled to
(S', 2^n) with each member's single-qubit rotations applied as one
batched pass per qubit (gathered from a (3, 2, 2) table by the member's
basis draw — the JAX package's ``vmap``), then one inverse-CDF draw per
member from a seeded ``torch.Generator`` (in place of
``jax.random.categorical``: reproducible from the seed, not the JAX
package's bits).  The bases come from the JAX package's numpy draw, so
they are identical; only the (S, n) bases and the (S,) outcomes cross
the boundary, the outcomes once at the end.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .config import SimulatorConfig
from .ir.circuit import Circuit

# rotation to measure in basis b: 0 = X (H), 1 = Y (H Sdg), 2 = Z (I)
_SQ = 1.0 / np.sqrt(2.0)
_ROT = np.stack([
    np.array([[_SQ, _SQ], [_SQ, -_SQ]], dtype=complex),            # H
    np.array([[_SQ, -1j * _SQ], [_SQ, 1j * _SQ]], dtype=complex),  # H Sdg
    np.eye(2, dtype=complex),
])
_AXIS = {"X": 0, "Y": 1, "Z": 2}


def shadow_snapshots(
    circuit: Circuit,
    snapshots: int,
    seed: int = 0,
    config: Optional[SimulatorConfig] = None,
    max_batch_log2: int = 24,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """(bases, outcomes): S random-Pauli-basis measurement snapshots.

    ``bases[s, q]`` in {0, 1, 2} = {X, Y, Z}; ``outcomes[s]`` = the sampled
    basis index (bit q = qubit q's result in its basis).  Chunked so a
    member batch never exceeds 2^max_batch_log2 amplitudes."""
    import torch

    from .engine.simulator import Simulator
    from .gradients import _apply_1q_rows
    from .ops.apply import upload

    cfg = config or SimulatorConfig()
    sim = Simulator(cfg, device=device)
    n = circuit.num_qubits
    re, im, _ = sim.run_device(circuit)
    dev = re.device

    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 3, size=(int(snapshots), n), dtype=np.int8)

    rot = upload(np.stack([_ROT.real, _ROT.imag]).astype(np.float32), dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    S = int(snapshots)
    per = max(1, 1 << max(0, max_batch_log2 - n))
    outs = []
    for lo in range(0, S, per):
        hi = min(S, lo + per)
        b = upload(bases[lo:hi].astype(np.int64), dev)       # (m, n)
        m = hi - lo
        r = re.expand(m, -1)
        i = im.expand(m, -1)
        for q in range(n):
            ur, ui = rot[0][b[:, q]], rot[1][b[:, q]]         # (m, 2, 2)
            r, i = _apply_1q_rows(r, i, ur, ui, q, n)
        cdf = torch.cumsum(r * r + i * i, dim=1)
        u = torch.rand((m, 1), generator=gen, device=dev,
                       dtype=cdf.dtype) * cdf[:, -1:]
        idx = torch.searchsorted(cdf, u, right=True)
        outs.append(torch.clamp(idx[:, 0], max=(1 << n) - 1))
    if not outs:
        return bases, np.zeros(0, np.int64)
    return bases, torch.cat(outs).cpu().numpy().astype(np.int64)


def shadows_expectation(
    circuit: Circuit,
    terms: Sequence[Tuple[float, str]],
    snapshots: int = 10000,
    seed: int = 0,
    groups: int = 10,
    config: Optional[SimulatorConfig] = None,
    _snapshot_data=None,
    device="cuda",
) -> float:
    """<H> = sum c_k <P_k> from ONE pool of classical-shadow snapshots.

    Each snapshot where every qubit in P's support drew P's basis
    contributes prod_supp 3 * (+-1); median-of-means over ``groups``
    batches tames heavy tails.  All terms share the pool — the estimator's
    whole point.  ``_snapshot_data``: reuse (bases, outcomes) from
    :func:`shadow_snapshots` across calls.  The snapshots run on
    ``device`` (the card unless ``device="cpu"``)."""
    from .observables import _parse_pauli

    n = circuit.num_qubits
    if _snapshot_data is None:
        bases, outcomes = shadow_snapshots(circuit, snapshots, seed, config,
                                           device=device)
    else:
        bases, outcomes = _snapshot_data
    S = bases.shape[0]

    total = 0.0
    for coeff, pauli in terms:
        ops = _parse_pauli(pauli, n)
        if not ops:
            total += float(coeff)
            continue
        est = np.ones(S)
        for q, ax in ops.items():
            match = bases[:, q] == _AXIS[ax]
            sign = 1.0 - 2.0 * ((outcomes >> q) & 1)
            est = est * np.where(match, 3.0 * sign, 0.0)
        # median of means
        g = max(1, int(groups))
        cut = (S // g) * g
        means = est[:cut].reshape(g, -1).mean(axis=1) if cut else est
        total += float(coeff) * float(np.median(means))
    return total


def shadows_reduced_density(
    bases: np.ndarray,
    outcomes: np.ndarray,
    qubits: Sequence[int],
) -> np.ndarray:
    """Reconstruct the reduced density matrix of ``qubits`` from shadow
    snapshots: rho_A = E_s [ prod_q (3 U_q^dag |b_q><b_q| U_q - I) ].

    Little-endian over ``qubits`` in the given order.  Unbiased; error
    ~sqrt(4^k/S).  Feed the (bases, outcomes) pool from
    :func:`shadow_snapshots`."""
    qs = [int(q) for q in qubits]
    if len(set(qs)) != len(qs):
        raise ValueError("qubits must be distinct")
    S = bases.shape[0]
    # per-(basis, bit) single-qubit estimator 3 U^dag |b><b| U - I
    est = np.empty((3, 2, 2, 2), dtype=complex)
    for b in range(3):
        u = _ROT[b]
        for bit in range(2):
            proj = np.zeros((2, 2), dtype=complex)
            proj[bit, bit] = 1.0
            est[b, bit] = 3.0 * (u.conj().T @ proj @ u) - np.eye(2)
    rho = np.zeros((1 << len(qs),) * 2, dtype=complex)
    for s in range(S):
        m = np.array([[1.0]], dtype=complex)
        for q in qs:
            m = np.kron(est[bases[s, q], (int(outcomes[s]) >> q) & 1], m)
        rho += m
    rho /= S
    return rho
