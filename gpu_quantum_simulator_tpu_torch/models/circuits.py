"""Circuit families ("models") for tests and benchmarks.

The reference benchmarks over uncommitted random circuits
(``random_circs_ad/random_<n>.qasm``, tester.bash:12) plus two committed
workloads: ``entanglement.qasm`` (Bell) and ``grover_3_18.qasm`` (6 qubits,
2445 gates: 1024 cx / 1212 rz / 174 sx / 35 x).  ``random_circuit`` here
regenerates that distribution reproducibly; ``grover_like`` uses exactly the
grover_3_18 gate mix so sweeps are comparable across qubit counts.

The port's JAX-free copy of ``gpu_quantum_simulator_tpu/models/circuits.py``,
held to the original gate for gate by tests/test_torch_models.py, except
``load_reference_circuit``, which needs the QASM front-end.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence

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


def qft(n: int) -> Circuit:
    """Quantum Fourier transform in the reference gate set.

    Controlled-phase CP(theta) decomposes as
    rz(theta/2) on both qubits, cx, rz(-theta/2) target, cx
    (exact under this library's rz = diag(1, e^{i theta}) convention up to
    the global-phase-free identity CP(t)=P_c(t/2) P_t(t/2) CX P_t(-t/2) CX).
    The final qubit-reversal swaps are emitted as 3-cx swaps.
    """
    c = Circuit(n)
    for j in reversed(range(n)):
        c.h(j)
        for k in reversed(range(j)):
            theta = math.pi / (1 << (j - k))
            c.rz(theta / 2, j)
            c.rz(theta / 2, k)
            c.cx(k, j)
            c.rz(-theta / 2, j)
            c.cx(k, j)
    for q in range(n // 2):
        a, b = q, n - 1 - q
        c.cx(a, b).cx(b, a).cx(a, b)
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


from ..ir.decompose import emit_ccx as _ccx, emit_cz as _cz  # shared decompositions


def _controlled_z_all(c: Circuit, data, anc) -> None:
    """Phase-flip |1...1> over ``data`` using a clean-ancilla Toffoli ladder."""
    n = len(data)
    if n == 1:
        c.z(data[0])
        return
    if n == 2:
        _cz(c, data[0], data[1])
        return
    assert len(anc) >= n - 2
    _ccx(c, data[0], data[1], anc[0])
    for i in range(2, n - 1):
        _ccx(c, data[i], anc[i - 2], anc[i - 1])
    _cz(c, data[n - 1], anc[n - 3])
    for i in reversed(range(2, n - 1)):
        _ccx(c, data[i], anc[i - 2], anc[i - 1])
    _ccx(c, data[0], data[1], anc[0])


def grover_parts(
    num_data_qubits: int,
    marked: int,
    iterations: Optional[int] = None,
):
    """(prefix, body, iterations) for Grover search — body is ONE iteration.

    Use with ``Simulator.run_device_iterated(body, iterations, prefix=...)``
    so the iteration block compiles once regardless of depth.
    """
    n = num_data_qubits
    if not (0 <= marked < (1 << n)):
        raise ValueError("marked state out of range")
    anc = list(range(n, n + max(0, n - 2)))
    data = list(range(n))
    if iterations is None:
        iterations = max(1, int(round(math.pi / 4 * math.sqrt(1 << n))))

    prefix = Circuit(n + len(anc))
    for q in data:
        prefix.h(q)

    body = Circuit(n + len(anc))
    # oracle: phase-flip |marked>
    for q in data:
        if not (marked >> q) & 1:
            body.x(q)
    _controlled_z_all(body, data, anc)
    for q in data:
        if not (marked >> q) & 1:
            body.x(q)
    # diffusion
    for q in data:
        body.h(q)
        body.x(q)
    _controlled_z_all(body, data, anc)
    for q in data:
        body.x(q)
        body.h(q)
    return prefix, body, iterations


def grover(
    num_data_qubits: int,
    marked: int,
    iterations: Optional[int] = None,
) -> Circuit:
    """A real Grover search circuit in the reference gate set.

    ``num_data_qubits`` data qubits plus max(0, n-2) clean ancillas for the
    multi-controlled Z (Toffoli ladder, uncomputed).  The committed
    grover_3_18.qasm is a 6-qubit instance of this family; this builder
    scales it to arbitrary n (grover(16) = a 30-qubit circuit — the
    reference's hardware ceiling was n=22).
    """
    prefix, body, iterations = grover_parts(num_data_qubits, marked, iterations)
    c = Circuit(prefix.num_qubits, list(prefix.gates))
    for _ in range(iterations):
        c.gates.extend(body.gates)
    return c


def _zz_interaction(c: Circuit, theta: float, a: int, b: int) -> None:
    """exp(-i*(theta/2)*Z_a Z_b) up to a global phase.

    CX(a,b); rz(theta, b); CX(a,b) puts phase e^{i*theta} on odd-parity
    basis states (rz = diag(1, e^{i theta}), reference convention,
    quantum_simulator.c:205-208), which equals e^{i theta/2} *
    exp(-i (theta/2) ZZ)."""
    c.cx(a, b)
    c.rz(theta, b)
    c.cx(a, b)


def _rx_via_h(c: Circuit, theta: float, q: int) -> None:
    """exp(-i*(theta/2)*X) up to a global phase: H; rz(theta); H."""
    c.h(q)
    c.rz(theta, q)
    c.h(q)


def ring_edges(n: int):
    """Edge list of the n-cycle (the standard QAOA MaxCut benchmark graph)."""
    return [(i, (i + 1) % n) for i in range(n)]


def qaoa_maxcut_parts(
    num_qubits: int,
    edges: Optional[Sequence] = None,
    gamma: float = 0.7,
    beta: float = 0.4,
    layers: int = 1,
):
    """(prefix, body, layers) for uniform-angle QAOA MaxCut.

    ``prefix`` prepares |+...+>; ``body`` is ONE layer
    U_B(beta) U_C(gamma) with U_C = prod_edges e^{-i gamma (1 - Z_a Z_b)/2}
    (global phase dropped) and U_B = prod_q e^{-i beta X_q}.  Uniform
    angles across layers make the body a fixed block, so it runs through
    ``Simulator.run_device_iterated`` with one compile regardless of depth
    (the TPU analog of the reference's constant-table re-upload loop,
    quantum_simulator_preproces_constant_only.cu:312-340).
    """
    n = num_qubits
    edges = list(edges) if edges is not None else ring_edges(n)
    for a, b in edges:
        if not (0 <= a < n and 0 <= b < n and a != b):
            raise ValueError(f"bad edge ({a}, {b}) for n={n}")
    prefix = Circuit(n)
    for q in range(n):
        prefix.h(q)
    body = Circuit(n)
    for a, b in edges:
        _zz_interaction(body, -float(gamma), a, b)  # e^{+i gamma/2 ZZ} ~ e^{-i gamma C_edge}
    for q in range(n):
        _rx_via_h(body, 2.0 * float(beta), q)
    return prefix, body, int(layers)


def qaoa_maxcut(
    num_qubits: int,
    edges: Optional[Sequence] = None,
    gammas: Sequence[float] = (0.7,),
    betas: Sequence[float] = (0.4,),
) -> Circuit:
    """Full QAOA MaxCut circuit with a per-layer angle schedule."""
    if len(gammas) != len(betas):
        raise ValueError("gammas and betas must have equal length")
    c = None
    for gamma, beta in zip(gammas, betas):
        prefix, body, _ = qaoa_maxcut_parts(num_qubits, edges, gamma, beta)
        if c is None:
            c = Circuit(prefix.num_qubits, list(prefix.gates))
        c.gates.extend(body.gates)
    if c is None:
        c = Circuit(num_qubits)
        for q in range(num_qubits):
            c.h(q)
    return c


def w_state(num_qubits: int) -> Circuit:
    """|W_n> = (|10...0> + |01...0> + ... + |0...01>) / sqrt(n).

    Cascade construction: qubit 0 starts the excitation with
    ry(2 acos(sqrt(1/n))); each step passes the remaining amplitude down
    with a controlled rotation (decomposed through the native gate set:
    cry(t) = ry(t/2); cx; ry(-t/2); cx) followed by cx back-transfer."""
    import math as _m

    n = num_qubits
    if n < 1:
        raise ValueError("w_state needs >= 1 qubit")
    c = Circuit(n)
    if n == 1:
        c.x(0)
        return c
    # excitation starts on qubit 0 with full weight
    c.x(0)
    for k in range(n - 1):
        # move amplitude sqrt((n-1-k)/(n-k)) of the excitation from qubit k
        # to qubit k+1: controlled-ry from k on k+1, then cx back
        theta = 2.0 * _m.acos(_m.sqrt(1.0 / (n - k)))
        c.ry(theta / 2, k + 1)
        c.cx(k, k + 1)
        c.ry(-theta / 2, k + 1)
        c.cx(k, k + 1)
        c.cx(k + 1, k)
    return c


def bernstein_vazirani(secret: int, num_qubits: int) -> Circuit:
    """BV circuit recovering ``secret`` (an n-bit mask) in one query.

    Qubits 0..n-1 = the query register, qubit n = the |-> ancilla; the
    oracle f(x) = s.x is a cx from each secret bit.  Measuring the query
    register yields ``secret`` with probability 1."""
    n = num_qubits
    if not 0 <= secret < (1 << n):
        raise ValueError(f"secret {secret} needs more than {n} bits")
    c = Circuit(n + 1)
    c.x(n)
    c.h(n)
    for q in range(n):
        c.h(q)
    for q in range(n):
        if (secret >> q) & 1:
            c.cx(q, n)
    for q in range(n):
        c.h(q)
    return c


def simon(secret: int, num_bits: int) -> Circuit:
    """Simon's problem: query register measures only y with y.s = 0.

    Qubits 0..n-1 = query register, n..2n-1 = oracle output.  The oracle
    copies x to the output (cx fan-out), then XORs ``secret`` into it
    controlled on the lowest set bit i0 of the secret — a 2-to-1 function
    with f(x) = f(x XOR s) (bijective when s = 0).  After the final
    Hadamards every measured query string y satisfies parity(y & s) = 0;
    n-1 independent samples determine s via GF(2) elimination
    (:func:`simon_secret_from_samples`)."""
    n = num_bits
    if not 0 <= secret < (1 << n):
        raise ValueError(f"secret {secret} needs more than {n} bits")
    c = Circuit(2 * n)
    for q in range(n):
        c.h(q)
    for q in range(n):
        c.cx(q, n + q)
    if secret:
        i0 = (secret & -secret).bit_length() - 1
        for k in range(n):
            if (secret >> k) & 1:
                c.cx(i0, n + k)
    for q in range(n):
        c.h(q)
    return c


def simon_secret_from_samples(samples, num_bits: int) -> Optional[int]:
    """Recover Simon's secret from query-register samples by GF(2)
    elimination: the samples span the hyperplane orthogonal to s, so the
    one-dimensional null space of the row space is {0, s}.  Returns the
    nonzero secret, 0 when the rows span the full space (s = 0), or None
    when the samples are insufficient (null space still > 1-dimensional)."""
    n = num_bits
    basis: Dict[int, int] = {}       # pivot bit -> fully reduced row
    for y in samples:
        v = int(y) & ((1 << n) - 1)
        while v:
            b = v.bit_length() - 1
            if b in basis:
                v ^= basis[b]
                continue
            for p in sorted(basis, reverse=True):
                if (v >> p) & 1:         # clear lower pivots from v too
                    v ^= basis[p]
            for p, r in basis.items():   # back-substitute: keep RREF
                if (r >> b) & 1:
                    basis[p] = r ^ v
            basis[b] = v
            break
    rank = len(basis)
    if rank == n:
        return 0
    if rank < n - 1:
        return None
    # RREF rows are 2^pivot (+ the free bit): the null vector sets the
    # free bit and every pivot whose row contains it
    free = next(b for b in range(n) if b not in basis)
    s = 1 << free
    for p, r in basis.items():
        if (r >> free) & 1:
            s |= 1 << p
    return s


def deutsch_jozsa(num_qubits: int, balanced: bool = True,
                  mask: int = 1) -> Circuit:
    """Deutsch-Jozsa: query register measures 0 iff f is constant.

    ``balanced=True`` uses f(x) = parity(mask & x) (any nonzero mask);
    ``balanced=False`` uses the constant oracle f = 0."""
    n = num_qubits
    if balanced and not 0 < mask < (1 << n):
        raise ValueError("balanced oracle needs a nonzero n-bit mask")
    c = Circuit(n + 1)
    c.x(n)
    c.h(n)
    for q in range(n):
        c.h(q)
    if balanced:
        for q in range(n):
            if (mask >> q) & 1:
                c.cx(q, n)
    for q in range(n):
        c.h(q)
    return c


def _controlled_p(c: Circuit, phi: float, ctrl: int, tgt: int) -> None:
    """diag(1,1,1,e^{i phi}) from the gate set (qelib1 cu1 pattern)."""
    c.p(phi / 2, ctrl)
    c.cx(ctrl, tgt)
    c.p(-phi / 2, tgt)
    c.cx(ctrl, tgt)
    c.p(phi / 2, tgt)


def phase_estimation(num_eval_qubits: int, theta: float) -> Circuit:
    """Quantum phase estimation of the eigenphase of p(theta) on |1>.

    m = num_eval_qubits eval qubits (0..m-1) + the eigenstate qubit m.
    Controlled-U^(2^k) is controlled-p(2^k theta) from eval qubit k, so
    after the inverse QFT the eval register peaks at the little-endian
    index a with theta ~ 2 pi a / 2^m (exact for dyadic theta).  Exercises
    Circuit.inverse + compose on the QFT block.
    """
    m = num_eval_qubits
    c = Circuit(m + 1)
    c.x(m)
    for k in range(m):
        c.h(k)
    for k in range(m):
        _controlled_p(c, (1 << k) * float(theta), k, m)
    c.compose(qft(m).inverse(), qubits=range(m))
    return c


# every unit mod 15 is +-2^r: value -> (rotation index r, complement?)
_MOD15_UNITS = {1: (0, False), 2: (1, False), 4: (2, False), 8: (3, False),
                14: (0, True), 13: (1, True), 11: (2, True), 7: (3, True)}
# 4-bit rotate-left by r as transposition chains over work-bit indices
_ROTL_SWAPS = {1: ((2, 3), (1, 2), (0, 1)),
               2: ((0, 2), (1, 3)),
               3: ((0, 1), (1, 2), (2, 3))}


def shor_order_finding(a: int = 7, num_eval_qubits: int = 8) -> Circuit:
    """Compiled Shor order-finding circuit for N = 15 (factoring demo).

    Eval register = qubits 0..t-1 (little-endian phase index, the
    :func:`phase_estimation` convention); work register = qubits t..t+3
    holding x = 1.  The controlled multipliers a^(2^j) mod 15 compile to
    named 1q/2q gates because every unit mod 15 is +-2^r: x -> 2x mod 15
    rotates the 4 work bits left (2^4 = 1 mod 15) and x -> -x mod 15 is
    the bitwise complement (x + ~x = 15), so each multiplier costs at
    most 3 cswaps + 4 cx (Vandersypen-style compiled modular
    exponentiation).  After the inverse QFT the eval register peaks
    EXACTLY at the r-th multiples s * 2^t / r of the dyadic eigenphases
    (r = order of a mod 15: 4 for a in {2, 7, 8, 13}, 2 for {4, 11, 14}).
    Beyond-reference workload: the reference ships no algorithm library.
    """
    from ..ir.decompose import emit_cswap

    t = int(num_eval_qubits)
    if t < 2:
        raise ValueError("need at least 2 eval qubits")
    a = int(a) % 15
    if a not in _MOD15_UNITS or a == 1:
        raise ValueError(f"a must be a unit mod 15 and != 1, got {a}")
    c = Circuit(t + 4)
    w = [t + k for k in range(4)]
    c.x(w[0])                       # work register starts at |x=1>
    for q in range(t):
        c.h(q)
    for j in range(t):
        m = pow(a, 1 << j, 15)
        if m == 1:
            continue                # higher squarings collapse to identity
        r, neg = _MOD15_UNITS[m]
        for lo, hi in _ROTL_SWAPS.get(r, ()):
            emit_cswap(c, j, w[lo], w[hi])
        if neg:                     # rotation and complement commute
            for k in range(4):
                c.cx(j, w[k])
    c.compose(qft(t).inverse(), qubits=range(t))
    return c


def shor_factors_from_index(index: int, num_eval_qubits: int, a: int,
                            modulus: int = 15):
    """Classical Shor post-processing: measured eval index -> factor pair.

    ``index / 2^t ~ s / r`` for the order r of ``a``; the continued
    fraction (``Fraction.limit_denominator``) recovers a divisor of r,
    small multiples restore r itself, and ``gcd(a^(r/2) +- 1, N)`` splits
    N when r is even and a^(r/2) != -1.  Returns the sorted nontrivial
    pair (p, q) or None (index 0, odd order, or the trivial -1 root).
    """
    from fractions import Fraction
    from math import gcd

    t = int(num_eval_qubits)
    if int(index) % (1 << t) == 0:
        return None                 # phase 0 carries no order information
    d = Fraction(int(index), 1 << t).limit_denominator(modulus).denominator
    r = next((d * k for k in range(1, modulus // d + 1)
              if pow(a, d * k, modulus) == 1), None)
    if r is None or r % 2:
        return None
    y = pow(a, r // 2, modulus)
    if y == modulus - 1:
        return None
    p, q = gcd(y - 1, modulus), gcd(y + 1, modulus)
    pair = tuple(sorted((p, q)))
    return pair if pair[0] > 1 and pair[0] * pair[1] == modulus else None


def qaoa_maxcut_tied(
    num_qubits: int,
    edges: Optional[Sequence] = None,
    gammas: Sequence[float] = (0.7,),
    betas: Sequence[float] = (0.4,),
):
    """(circuit, tie, terms) for gradient-based QAOA MaxCut optimization.

    Same circuit as :func:`qaoa_maxcut`, plus the parameter-tying map for
    ``gradients.make_adjoint_value_and_grad``: slot l is gamma_l, slot
    ``p + l`` is beta_l (p = number of layers).  Each edge's rz carries
    angle ``-gamma_l`` (scale -1) and each mixer rz carries ``2 beta_l``
    (scale 2), so one adjoint sweep returns exact d<C>/dgamma_l and
    d<C>/dbeta_l; ``terms`` is the MaxCut cost from
    :func:`maxcut_cost_terms`.
    """
    if len(gammas) != len(betas):
        raise ValueError("gammas and betas must have equal length")
    n = num_qubits
    edges = list(edges) if edges is not None else ring_edges(n)
    layers = len(gammas)
    c = Circuit(n)
    for q in range(n):
        c.h(q)
    tie = {}
    for l, (gamma, beta) in enumerate(zip(gammas, betas)):
        for a, b in edges:
            _zz_interaction(c, -float(gamma), a, b)
            tie[len(c.gates) - 2] = (l, -1.0)          # the rz inside cx-rz-cx
        for q in range(n):
            _rx_via_h(c, 2.0 * float(beta), q)
            tie[len(c.gates) - 2] = (layers + l, 2.0)  # the rz inside h-rz-h
    return c, tie, maxcut_cost_terms(n, edges)


def maxcut_cost_terms(num_qubits: int, edges: Optional[Sequence] = None):
    """MaxCut cost C = sum_edges (1 - Z_a Z_b)/2 as (coeff, pauli) terms
    for ``observables.expectation_pauli_sum``."""
    edges = list(edges) if edges is not None else ring_edges(num_qubits)
    terms = [(0.5 * len(edges), "I" * num_qubits)]
    for a, b in edges:
        terms.append((-0.5, f"Z{a} Z{b}"))  # sparse Pauli spec (observables._parse_pauli)
    return terms


def tfim_terms(num_qubits: int, J: float = 1.0, g: float = 1.0,
               periodic: bool = False):
    """H = -J sum Z_i Z_{i+1} - g sum X_i as (coeff, pauli) terms —
    the Hamiltonian :func:`trotter_tfim_parts` evolves under, for
    ``observables.expectation_pauli_sum`` / VQE objectives."""
    n = num_qubits
    terms = [(-float(J), f"Z{i} Z{i + 1}") for i in range(n - 1)]
    if periodic and n > 2:
        terms.append((-float(J), f"Z{n - 1} Z0"))
    terms += [(-float(g), f"X{i}") for i in range(n)]
    return terms


def heisenberg_terms(num_qubits: int, Jx: float = 1.0, Jy: float = 1.0,
                     Jz: float = 1.0, h: float = 0.0,
                     periodic: bool = False):
    """XYZ Heisenberg chain H = sum_i (Jx XX + Jy YY + Jz ZZ) + h sum Z_i
    as (coeff, pauli) terms."""
    n = num_qubits
    bonds = [(i, i + 1) for i in range(n - 1)]
    if periodic and n > 2:
        bonds.append((n - 1, 0))
    terms = []
    for a, b in bonds:
        for Jc, ax in ((Jx, "X"), (Jy, "Y"), (Jz, "Z")):
            if Jc:
                terms.append((float(Jc), f"{ax}{a} {ax}{b}"))
    if h:
        terms += [(float(h), f"Z{i}") for i in range(n)]
    return terms


def trotter_tfim_parts(
    num_qubits: int,
    dt: float,
    J: float = 1.0,
    g: float = 1.0,
    steps: int = 10,
    periodic: bool = False,
    order: int = 1,
):
    """(prefix, body, steps) for Trotter evolution of the transverse-field
    Ising model H = -J sum Z_i Z_{i+1} - g sum X_i starting from |0...0>.

    ``order=1`` (Lie-Trotter, global error O(dt)): one step is
    prod_bonds e^{+i dt J Z Z} . prod_sites e^{+i dt g X}.
    ``order=2`` (Strang/symmetric, global error O(dt^2)): half-step X,
    full ZZ, half-step X.  Either body is the same block every step —
    the canonical ``run_device_iterated`` workload."""
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    n = num_qubits
    prefix = Circuit(n)  # |0...0> is the quench initial state
    body = Circuit(n)
    bonds = [(i, i + 1) for i in range(n - 1)]
    if periodic and n > 2:
        bonds.append((n - 1, 0))
    x_angle = -2.0 * float(g) * float(dt) / order
    if order == 2:
        for q in range(n):
            _rx_via_h(body, x_angle, q)  # e^{+i (dt/2) g X}
    for a, b in bonds:
        _zz_interaction(body, -2.0 * float(J) * float(dt), a, b)  # e^{+i dt J ZZ}
    for q in range(n):
        _rx_via_h(body, x_angle, q)
    return prefix, body, int(steps)


def _xx_interaction(c: Circuit, theta: float, a: int, b: int) -> None:
    """exp(-i*(theta/2)*X_a X_b): ZZ conjugated by H on both qubits."""
    c.h(a)
    c.h(b)
    _zz_interaction(c, theta, a, b)
    c.h(a)
    c.h(b)


def _yy_interaction(c: Circuit, theta: float, a: int, b: int) -> None:
    """exp(-i*(theta/2)*Y_a Y_b): ZZ conjugated by V = H Sdg (V Y V^dag = Z)."""
    for q in (a, b):
        c.sdg(q)
        c.h(q)
    _zz_interaction(c, theta, a, b)
    for q in (a, b):
        c.h(q)
        c.s(q)


def trotter_heisenberg_parts(
    num_qubits: int,
    dt: float,
    Jx: float = 1.0,
    Jy: float = 1.0,
    Jz: float = 1.0,
    h: float = 0.0,
    steps: int = 10,
    periodic: bool = False,
):
    """(prefix, body, steps) for first-order Trotter evolution under the
    XYZ Heisenberg chain of :func:`heisenberg_terms` from |0...0>.

    One step applies exp(-i dt Jx XX) exp(-i dt Jy YY) exp(-i dt Jz ZZ)
    per bond (XX/YY as basis-conjugated ZZ interactions) then the field
    exp(-i dt h Z) per site; the body is a fixed block — iterate with
    ``run_device_iterated``."""
    n = num_qubits
    prefix = Circuit(n)
    body = Circuit(n)
    bonds = [(i, i + 1) for i in range(n - 1)]
    if periodic and n > 2:
        bonds.append((n - 1, 0))
    for a, b in bonds:
        if Jx:
            _xx_interaction(body, 2.0 * float(Jx) * float(dt), a, b)
        if Jy:
            _yy_interaction(body, 2.0 * float(Jy) * float(dt), a, b)
        if Jz:
            _zz_interaction(body, 2.0 * float(Jz) * float(dt), a, b)
    if h:
        for q in range(n):
            # rz = diag(1, e^{i theta}): exp(-i dt h Z) ~ rz(+2 h dt) phase
            body.rz(2.0 * float(h) * float(dt), q)
    return prefix, body, int(steps)


def trotter_heisenberg(
    num_qubits: int,
    dt: float,
    Jx: float = 1.0,
    Jy: float = 1.0,
    Jz: float = 1.0,
    h: float = 0.0,
    steps: int = 10,
    periodic: bool = False,
) -> Circuit:
    """Unrolled first-order Heisenberg Trotter circuit."""
    prefix, body, steps = trotter_heisenberg_parts(
        num_qubits, dt, Jx, Jy, Jz, h, steps, periodic)
    c = Circuit(prefix.num_qubits, list(prefix.gates))
    for _ in range(steps):
        c.gates.extend(body.gates)
    return c


def trotter_tfim(
    num_qubits: int,
    dt: float,
    J: float = 1.0,
    g: float = 1.0,
    steps: int = 10,
    periodic: bool = False,
    order: int = 1,
) -> Circuit:
    """Unrolled Trotter TFIM circuit (see trotter_tfim_parts)."""
    prefix, body, steps = trotter_tfim_parts(num_qubits, dt, J, g, steps,
                                             periodic, order)
    c = Circuit(prefix.num_qubits, list(prefix.gates))
    for _ in range(steps):
        c.gates.extend(body.gates)
    return c


# The reference's circuit files (entanglement.qasm, grover_3_18.qasm, ...)
# are read from a ``reference/`` directory at the repository's root when a
# checkout of the reference is placed there; none is committed here.
_REFERENCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "reference")


def load_reference_circuit(name: str) -> Circuit:
    """Load a reference workload (entanglement / grover_3_18) through the
    port's QASM parser; a missing file raises OSError."""
    from ..qasm.parser import parse_qasm_file

    path = os.path.join(_REFERENCE_DIR,
                        name if name.endswith(".qasm") else name + ".qasm")
    return parse_qasm_file(path)


def quantum_volume(num_qubits: int, depth: Optional[int] = None,
                   seed: int = 0) -> Circuit:
    """IBM-style quantum-volume model circuit: ``depth`` layers (default
    ``num_qubits`` — the square QV shape), each a random qubit permutation
    followed by Haar-random SU(4) blocks on the paired qubits, lowered to
    native gates through the exact KAK decomposition
    (ir.decompose.emit_unitary).  The canonical whole-chip stress
    workload: no structure for the fusion passes to exploit beyond the
    pair blocks themselves."""
    import numpy as np

    if depth is None:
        depth = num_qubits
    rng = np.random.default_rng(seed)
    c = Circuit(num_qubits)
    for _ in range(depth):
        order = rng.permutation(num_qubits)
        for i in range(0, num_qubits - 1, 2):
            z = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
            q, r = np.linalg.qr(z)
            q = q * (np.diag(r) / np.abs(np.diag(r)))   # Haar-correct phase
            c.unitary(q, int(order[i]), int(order[i + 1]))
    return c


def pauli_evolution(num_qubits: int, terms, time: float, steps: int = 1,
                    order: int = 1) -> Circuit:
    """Trotterized exp(-i H t) for ANY Pauli-sum H = sum_j c_j P_j, given
    as (coeff, pauli) terms — the same format ``tfim_terms`` /
    ``heisenberg_terms`` produce and ``expectation_pauli_sum`` consumes.
    Each factor is one exact ``Circuit.pauli_rot`` (exp(-i theta/2 P) with
    theta = 2 c_j dt).  ``order=1``: Lie-Trotter (error ~ t^2/steps);
    ``order=2``: Strang splitting — half step forward, half step in
    reversed term order (error ~ t^3/steps^2)."""
    if steps < 1:
        raise ValueError("steps must be >= 1")
    if order not in (1, 2):
        raise ValueError("order must be 1 (Lie-Trotter) or 2 (Strang)")
    dt = float(time) / steps
    c = Circuit(num_qubits)
    terms = list(terms)
    for _ in range(steps):
        if order == 1:
            for coef, pauli in terms:
                c.pauli_rot(2.0 * float(coef) * dt, pauli)
        else:
            for coef, pauli in terms:
                c.pauli_rot(float(coef) * dt, pauli)
            for coef, pauli in reversed(terms):
                c.pauli_rot(float(coef) * dt, pauli)
    return c


def pauli_evolution_parts(num_qubits: int, terms, dt: float,
                          order: int = 1):
    """(prefix, body) for ``run_device_iterated``: ``body`` is ONE Trotter
    step of exp(-i H dt) for an arbitrary (coeff, pauli) Hamiltonian —
    the general-Hamiltonian analog of ``trotter_tfim_parts``.  Repeating
    the body ``steps`` times equals ``pauli_evolution(n, terms, steps*dt,
    steps, order)``; the iterated engines dispatch ALL repetitions as one
    device call."""
    prefix = Circuit(num_qubits)
    body = pauli_evolution(num_qubits, terms, dt, steps=1, order=order)
    return prefix, body
