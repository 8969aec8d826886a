"""Pauli-string observables: expectations of arbitrary I/X/Y/Z strings
and their weighted sums (Hamiltonians).

The port of ``gpu_quantum_simulator_tpu/observables.py``.  The host half
(``_parse_pauli``, ``qwc_groups``, the basis rotations, ``pauli_decompose``
and the eigenvalues of a reduced density matrix) is the JAX package's
code.  What XLA lowered there is torch ops on the state's device here:
``apply_pauli_parts``, ``inner_parts``, the reductions, and the products
that form a reduced density matrix, which run in IEEE fp32 (``ieee_fp32``:
TF32 off, the JAX package's ``Precision.HIGHEST``).  No hand kernel is
involved, as no Pallas kernel is in the JAX package.

Every entry point that runs a circuit takes the port's ``device`` ("cuda"
unless the caller passes ``device="cpu"``); the functions that take a
state run on the state's own device.

An X/Y factor is rotated into the Z basis by appending one-qubit basis
changes to the circuit (X -> H, Y -> S^dag then H), after which the
diagonal Z-string reduces on the device (sampling.expectation_z) with no
state transfer.  Strings are grouped by qubit-wise commutation, so a
k-term Hamiltonian costs one circuit execution per QWC group, not per
term.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import SimulatorConfig
from .ir.circuit import Circuit
from .kernels.wide import ieee_fp32


def _parse_pauli(pauli: str, num_qubits: int) -> Dict[int, str]:
    """{'X'|'Y'|'Z' by qubit} from either a dense string ("IXZY", qubit 0
    leftmost) or a sparse spec ("X0 Z3 Y5")."""
    ops: Dict[int, str] = {}
    s = pauli.strip().upper()
    if " " in s or any(ch.isdigit() for ch in s):
        for term in s.split():
            p, q = term[0], int(term[1:])
            if p not in "IXYZ":
                raise ValueError(f"bad Pauli factor {term!r}")
            if q >= num_qubits:
                raise ValueError(f"qubit {q} out of range in {pauli!r}")
            if p != "I":
                ops[q] = p
    else:
        if len(s) != num_qubits:
            raise ValueError(
                f"dense Pauli string length {len(s)} != {num_qubits} qubits")
        for q, p in enumerate(s):
            if p not in "IXYZ":
                raise ValueError(f"bad Pauli factor {p!r}")
            if p != "I":
                ops[q] = p
    return ops


def qwc_groups(
    terms: Sequence[Tuple[float, Dict[int, str]]],
) -> List[Tuple[tuple, List[Tuple[float, Dict[int, str]]]]]:
    """Bin parsed Pauli terms into qubit-wise-commuting groups.

    Terms are QWC-compatible when no qubit carries two DIFFERENT letters
    across them.  Greedy first-fit over terms sorted widest-first, as in
    the JAX package.  Returns [(rotation_basis, members)] in deterministic
    order."""
    bins: List[Tuple[Dict[int, str], List[Tuple[float, Dict[int, str]]]]] = []
    order = sorted(range(len(terms)),
                   key=lambda i: (-len(terms[i][1]),
                                  sorted(terms[i][1].items())))
    for i in order:
        coeff, ops = terms[i]
        for letters, members in bins:
            if all(letters.get(q, p) == p for q, p in ops.items()):
                letters.update(ops)
                members.append((coeff, ops))
                break
        else:
            bins.append((dict(ops), [(coeff, ops)]))
    return [(tuple(sorted((q, p) for q, p in letters.items() if p != "Z")),
             members) for letters, members in bins]


def _with_rotations(circuit: Circuit, basis) -> Circuit:
    c = Circuit(circuit.num_qubits, list(circuit.gates))
    for q, p in basis:
        if p == "X":
            c.h(q)
        elif p == "Y":
            c.sdg(q)
            c.h(q)
    return c


def apply_pauli_parts(re, im, ops: Dict[int, str], num_qubits: int,
                      rows: int = 1):
    """P|psi> for one Pauli string on a split (re, im) state, on its device
    (X = pair flip, Y = flip with the i factor rotated into the parts, Z =
    sign flip).  Returns new flat tensors; the input is not changed.
    ``rows`` > 1: the flat tensors hold that many n-qubit states back to
    back, and each gets the string."""
    n = num_qubits
    for q, ax in ops.items():
        hi, lo = rows << (n - 1 - q), 1 << q
        r = re.reshape(hi, 2, lo)
        i = im.reshape(hi, 2, lo)
        if ax == "X":
            re, im = r.flip(1).reshape(-1), i.flip(1).reshape(-1)
        elif ax == "Y":
            # (Y v)_0 = -i v_1, (Y v)_1 = i v_0
            re = torch.stack([i[:, 1, :], -i[:, 0, :]], 1).reshape(-1)
            im = torch.stack([-r[:, 1, :], r[:, 0, :]], 1).reshape(-1)
        else:
            # the sign flip as a negation (no constant uploaded: nothing
            # here waits for the device)
            re = torch.stack([r[:, 0, :], -r[:, 1, :]], 1).reshape(-1)
            im = torch.stack([i[:, 0, :], -i[:, 1, :]], 1).reshape(-1)
    return re, im


def inner_parts(lr, li, pr, pi):
    """<lambda|psi> of two split states as (Re, Im) 0-d tensors."""
    return (torch.dot(lr, pr) + torch.dot(li, pi),
            torch.dot(lr, pi) - torch.dot(li, pr))


def _pauli_sum_parts(re, im, parsed, num_qubits: int) -> torch.Tensor:
    """sum_k c_k <psi|P_k|psi> over parsed (coeff, ops) terms, as a 0-d
    tensor on the state's device: queued, not fetched (``run_many`` fetches
    every circuit's at the end).  A sharded state (shard lists) reduces
    shard by shard (``_pauli_sum_shards``)."""
    from .parallel.sharded import is_sharded

    if is_sharded(re):
        return _pauli_sum_shards(re, im, parsed, num_qubits)
    total = torch.zeros((), dtype=re.dtype, device=re.device)
    for coeff, ops in parsed:
        tr, ti = apply_pauli_parts(re, im, ops, num_qubits)
        total = total + coeff * (torch.dot(re, tr) + torch.dot(im, ti))
        del tr, ti
    return total


def _pauli_sum_shards(re, im, parsed, num_qubits: int) -> torch.Tensor:
    """``_pauli_sum_parts`` on a sharded state, without a join.

    A string's local factors act inside every shard (``apply_pauli_parts``
    at the local width); its factors on shard-index bits map shard s to
    shard t = s ^ (X/Y bits) with the phase i^(#Y) (-1)^(Z/Y bits of s).
    So <psi|P|psi> = sum_s Re(phase_s <psi_t|P_local psi_s>), a 0-d tensor
    on the first shard's device."""
    S = len(re)
    nl = num_qubits - (S.bit_length() - 1)
    first = re[0].device
    total = torch.zeros((), dtype=re[0].dtype, device=first)
    for coeff, ops in parsed:
        local = {q: a for q, a in ops.items() if q < nl}
        glob = {q - nl: a for q, a in ops.items() if q >= nl}
        xmask = sum(1 << g for g, a in glob.items() if a in "XY")
        zmask = sum(1 << g for g, a in glob.items() if a in "YZ")
        phase0 = 1j ** sum(1 for a in glob.values() if a == "Y")
        for s in range(S):
            t = s ^ xmask
            phase = phase0 * (-1) ** (bin(s & zmask).count("1") & 1)
            tr, ti = apply_pauli_parts(re[s], im[s], local, nl)
            tr, ti = tr.to(re[t].device), ti.to(re[t].device)
            a_re, a_im = inner_parts(re[t], im[t], tr, ti)
            val = phase.real * a_re - phase.imag * a_im
            total = total + coeff * val.to(first)
            del tr, ti
    return total


def _parse_terms(terms, num_qubits: int):
    """(parsed non-identity terms, constant from the identity terms)."""
    parsed: List[Tuple[float, Dict[int, str]]] = []
    const = 0.0
    for coeff, pauli in terms:
        ops = _parse_pauli(pauli, num_qubits)
        if not ops:
            const += coeff          # identity term
            continue
        parsed.append((float(coeff), ops))
    return parsed, const


def expectation_pauli(
    circuit: Circuit,
    pauli: str,
    config: Optional[SimulatorConfig] = None,
    device="cuda",
) -> float:
    """<P> for one Pauli string after running ``circuit``."""
    return expectation_pauli_sum(circuit, [(1.0, pauli)], config,
                                 device=device)


def expectation_pauli_sum(
    circuit: Circuit,
    terms: Sequence[Tuple[float, str]],
    config: Optional[SimulatorConfig] = None,
    method: str = "auto",
    device="cuda",
) -> float:
    """<H> for H = sum_k c_k P_k.

    ``method="basis"``: one circuit execution per qubit-wise-commuting
    group of terms (``qwc_groups``); every Z-string of a group reduces on
    the same device state.  ``method="state"``: ONE execution, every term
    a device-side <psi|P|psi> pass on the final state (a second state
    resident; n <= 28, the JAX package's rule, kept for parity).
    ``"auto"`` picks "state" when several bases exist and the width allows
    it.  Under the in-place split-state engine (n >= 30, or
    ``prefetch_inplace=True``) the basis method reduces each group on the
    four column halves (``sampling.expectation_z_halves``).
    """
    from .engine.simulator import Simulator
    from .sampling import expectation_z

    cfg = config or SimulatorConfig()
    sim = Simulator(cfg, device=device)
    n = circuit.num_qubits

    parsed, const = _parse_terms(terms, n)
    bins = qwc_groups(parsed)
    if method not in ("auto", "basis", "state"):
        raise ValueError(f"unknown method {method!r}")
    if method == "auto":
        method = ("state" if len(bins) > 1 and n <= 28
                  and cfg.strategy != "reference" else "basis")
    if method == "state":
        if cfg.strategy == "reference":
            raise ValueError("method='state' needs a device engine")
        re, im, _ = sim.run_device(circuit)
        return const + float(_pauli_sum_parts(re, im, parsed, n))

    # split-state route: the in-place prefetch engine never makes a flat
    # 2^n pair; each group's Z-strings reduce on the four column halves
    halves = (cfg.strategy == "prefetch" and sim._prefetch_inplace(n))

    total = const
    for basis, members in bins:
        rotated = _with_rotations(circuit, basis)
        if halves:
            from .sampling import expectation_z_halves

            parts, _ = sim.run_device_halves(rotated)
            for coeff, ops in members:
                total += coeff * expectation_z_halves(*parts, list(ops), n)
            continue
        if cfg.strategy == "reference":
            state = sim.run(rotated)
            p = np.abs(state) ** 2
            idx = np.arange(p.shape[0])
            for coeff, ops in members:
                par = np.zeros_like(idx)
                for q in ops:
                    par ^= (idx >> q) & 1
                total += coeff * float(np.sum(p * (1.0 - 2.0 * par)))
            continue
        re, im, _ = sim.run_device(rotated)
        for coeff, ops in members:
            total += coeff * expectation_z(re, im, list(ops), n)
    return total


def overlap(a, b, config: Optional[SimulatorConfig] = None,
            device="cuda") -> complex:
    """<psi_a | psi_b> with both states on the simulator's device.

    ``a`` / ``b``: a Circuit (run from |0...0>) or an explicit complex
    state vector.  The inner product reduces on the device (four dot
    products on the split pairs); one complex scalar reaches the host."""
    from .engine.simulator import Simulator

    cfg = config or SimulatorConfig()
    sim = Simulator(cfg, device=device)

    def parts(x):
        if isinstance(x, Circuit):
            re, im, _ = sim.run_device(x)
            return re, im, x.num_qubits
        arr = np.asarray(x)
        n = int(arr.shape[0]).bit_length() - 1
        if arr.shape[0] != 1 << n:
            raise ValueError(f"state length {arr.shape[0]} is not a power of 2")
        dt = torch.float64 if cfg.dtype == "complex128" else torch.float32
        return (torch.as_tensor(np.ascontiguousarray(arr.real), dtype=dt,
                                device=sim.device),
                torch.as_tensor(np.ascontiguousarray(arr.imag), dtype=dt,
                                device=sim.device), n)

    ra, ia, na = parts(a)
    rb, ib, nb = parts(b)
    if na != nb:
        raise ValueError(f"state widths differ: {na} vs {nb} qubits")
    # conj(a) . b = (ra - i ia) . (rb + i ib)
    real, imag = inner_parts(ra, ia, rb, ib)
    return complex(float(real), float(imag))


def state_fidelity(a, b, config: Optional[SimulatorConfig] = None,
                   device="cuda") -> float:
    """|<psi_a | psi_b>|^2 (pure-state fidelity), reduced on the device."""
    v = overlap(a, b, config, device=device)
    return v.real * v.real + v.imag * v.imag


def _check_qubits(qubits, num_qubits: int) -> List[int]:
    qs = [int(q) for q in qubits]
    if len(set(qs)) != len(qs):
        raise ValueError("qubits must be distinct")
    for q in qs:
        if not 0 <= q < num_qubits:
            raise ValueError(f"qubit {q} out of range")
    return qs


def _sum_out(p: torch.Tensor, keep, num_bits: int) -> torch.Tensor:
    """``p`` (2^num_bits,) with every bit not in ``keep`` summed out, from
    high to low so the positions of the kept bits stay valid: rank-3
    (hi, 2, lo) sums, never a (2,)*n view."""
    m = num_bits
    for q in range(num_bits - 1, -1, -1):
        if q in keep:
            continue
        hi, lo = 1 << (m - 1 - q), 1 << q
        p = p.reshape(hi, 2, lo).sum(dim=1).reshape(-1)
        m -= 1
    return p


def marginal_probabilities(re, im, qubits: Sequence[int],
                           num_qubits: int) -> np.ndarray:
    """Marginal outcome distribution over ``qubits`` (little-endian in the
    given order), reduced on the state's device; only the final
    2^len(qubits) vector reaches the host."""
    qs = _check_qubits(qubits, num_qubits)
    keep = sorted(qs)
    p = _sum_out((re * re + im * im).reshape(-1), set(keep), num_qubits)
    return _reorder_marginal(p.cpu().numpy(), keep, qs)


def _reorder_marginal(p: np.ndarray, keep, qs) -> np.ndarray:
    """Permute a little-endian-over-sorted(qs) marginal to the requested
    qubit order."""
    k = len(qs)
    if keep == qs or k == 0:
        return p
    pos = {q: i for i, q in enumerate(keep)}
    idx = np.arange(1 << k)
    out_idx = np.zeros_like(idx)
    for j, q in enumerate(qs):
        out_idx |= ((idx >> pos[q]) & 1) << j
    res = np.zeros_like(p)
    res[out_idx] = p
    return res


def marginal_probabilities_halves(re0, re1, im0, im1, qubits: Sequence[int],
                                  num_qubits: int) -> np.ndarray:
    """Marginal distribution over ``qubits`` from a column-half-split
    state (the in-place layout; ``Simulator.run_device_halves``).

    Each half is a (2^(n-8), 128) block (qubits 0..6 the lanes, qubit 7
    the half, qubits 8.. the rows), so both halves reduce on the device
    over their own (n-1)-bit index space as ``marginal_probabilities``
    does, and the two small results combine across qubit 7 on the host."""
    qs = _check_qubits(qubits, num_qubits)
    keep = sorted(qs)
    # within one half, original qubit q maps to bit q (q < 7) or q-1 (q > 7)
    mapped = {q if q < 7 else q - 1 for q in keep if q != 7}
    nn = num_qubits - 1

    def reduce_half(re, im):
        return _sum_out((re * re + im * im).reshape(-1), mapped,
                        nn).cpu().numpy()

    p0 = reduce_half(re0, im0)
    p1 = reduce_half(re1, im1)
    if 7 in keep:
        j7 = keep.index(7)
        i = np.arange(1 << (len(keep) - 1))
        base = (i & ((1 << j7) - 1)) | ((i >> j7) << (j7 + 1))
        p = np.zeros(1 << len(keep), dtype=p0.dtype)
        p[base] = p0
        p[base | (1 << j7)] = p1
    else:
        p = p0 + p1
    return _reorder_marginal(p, keep, qs)


def _rho_parts(re, im, D: int):
    """(Re, Im) of rho = V^dagger V for the state viewed as a (-1, D)
    matrix V, two IEEE fp32 matmul pairs on the state's device."""
    vr = re.reshape(-1, D)
    vi = im.reshape(-1, D)
    with ieee_fp32():
        # rho = (vr - i vi)^T (vr + i vi)
        return (vr.T @ vr + vi.T @ vi, vr.T @ vi - vi.T @ vr)


def _eigvals_f64(rr: torch.Tensor, ri: torch.Tensor) -> np.ndarray:
    """Eigenvalues of the Hermitian rr + i ri in float64, on the device
    that holds it: LAPACK on the CPU as in the JAX package, cuSOLVER on a
    card (float64 is native there; the JAX package fetches rho to the
    host only because the TPU has no float64)."""
    rho = torch.complex(rr.double(), ri.double())
    return torch.linalg.eigvalsh(rho).cpu().numpy()


def entanglement_entropy(re, im, cut: int, num_qubits: int,
                         base: float = 2.0) -> float:
    """Von Neumann entropy of the reduced state of qubits [0, cut).

    The state viewed as a (2^(n-cut), 2^cut) matrix V needs no SVD: the
    reduced density matrix rho = V^dagger V is a (2^cut, 2^cut) Hermitian
    formed by two matmul pairs in IEEE fp32 and diagonalized in float64.
    Entropy in bits by default (``base=np.e`` for nats)."""
    if not 1 <= cut < num_qubits:
        raise ValueError(f"cut must be in [1, {num_qubits - 1}], got {cut}")
    if cut > 14:
        raise ValueError(f"cut {cut} gives a 4^{cut}-entry density matrix; "
                         "cut from the smaller side")
    return _entropy_of_eigvals(_eigvals_f64(*_rho_parts(re, im, 1 << cut)),
                               base)


def _entropy_of_eigvals(w: np.ndarray, base: float) -> float:
    w = w[w > 1e-12]
    w = w / w.sum()
    return float(-(w * (np.log(w) / np.log(base))).sum())


def entanglement_entropy_halves(re0, re1, im0, im1, cut: int,
                                num_qubits: int, base: float = 2.0) -> float:
    """Von Neumann entropy of qubits [0, cut) from a column-half-split
    state.  For ``cut <= 7`` the cut qubits are lane bits inside BOTH
    halves, so rho = V0^dagger V0 + V1^dagger V1 with V_h = half h viewed
    as a (2^(n-1-cut), 2^cut) matrix."""
    if not 1 <= cut <= 7:
        raise ValueError("split-state entropy supports lane cuts 1..7; "
                         f"got {cut}")
    D = 1 << cut
    rr0, ri0 = _rho_parts(re0, im0, D)
    rr1, ri1 = _rho_parts(re1, im1, D)
    return _entropy_of_eigvals(
        _eigvals_f64(rr0.double() + rr1.double(), ri0.double() + ri1.double()),
        base)


def pauli_decompose(matrix, qubits: Optional[Sequence[int]] = None,
                    tol: float = 1e-12) -> List[Tuple[float, str]]:
    """Decompose a Hermitian matrix into (coeff, pauli) terms, the format
    ``expectation_pauli_sum`` / ``models.pauli_evolution`` consume.

    ``matrix``: (2^k, 2^k) Hermitian over k <= 6 qubits, basis index bit
    i = qubits[i].  ``qubits``: the qubit labels used in the emitted sparse
    specs (default 0..k-1).  Terms with |coeff| <= tol are dropped."""
    import itertools

    m = np.asarray(matrix, dtype=complex)
    k = int(round(np.log2(m.shape[0])))
    if m.shape != (1 << k, 1 << k) or 1 << k != m.shape[0]:
        raise ValueError(f"matrix shape {m.shape} is not (2^k, 2^k)")
    if k > 6:
        raise ValueError("pauli_decompose supports up to 6 qubits")
    if np.max(np.abs(m - m.conj().T)) > 1e-9:
        raise ValueError("matrix is not Hermitian")
    if qubits is None:
        qubits = tuple(range(k))
    qubits = tuple(qubits)
    if len(qubits) != k:
        raise ValueError(f"{k}-qubit matrix needs {k} qubit labels")

    P1 = {"I": np.eye(2, dtype=complex),
          "X": np.array([[0, 1], [1, 0]], dtype=complex),
          "Y": np.array([[0, -1j], [1j, 0]], dtype=complex),
          "Z": np.array([[1, 0], [0, -1]], dtype=complex)}
    out: List[Tuple[float, str]] = []
    for letters in itertools.product("IXYZ", repeat=k):
        # letters[i] acts on qubits[i] = basis bit i -> kron high..low
        p = np.eye(1, dtype=complex)
        for ch in reversed(letters):
            p = np.kron(p, P1[ch])
        coeff = np.trace(p.conj().T @ m) / (1 << k)
        if abs(coeff.imag) > 1e-9:  # pragma: no cover - Hermitian guard
            raise AssertionError("non-real Pauli coefficient")
        if abs(coeff.real) <= tol:
            continue
        if all(ch == "I" for ch in letters):
            spec = "I0"         # identity term: constant offset
        else:
            spec = " ".join(f"{ch}{qubits[i]}"
                            for i, ch in enumerate(letters) if ch != "I")
        out.append((float(coeff.real), spec))
    return out
