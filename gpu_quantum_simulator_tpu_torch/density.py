"""Density-matrix simulation with noise channels (vectorized superoperators).

The port of ``gpu_quantum_simulator_tpu/density.py``: the channels, the
superoperators, ``NoisyCircuit`` and the doubled op list are the JAX
package's host code; ``DensitySimulator.run`` takes the JAX package's
routes through the port's engines on the simulator's device (the card
unless ``device="cpu"``), and ``DensityResult`` reads the diagonal with
torch indexing on that device.

Beyond-reference capability: the reference simulates pure states only.  Here
a mixed state rho over n qubits runs as a VECTORIZED density matrix — a
2n-qubit state |rho> = sum_ij rho_ij |i>_ket |j>_bra with the ket index on
qubits 0..n-1 and the bra index on qubits n..2n-1.  Everything reuses the
existing engines:

* a gate U on qubits qs becomes TWO ops: U on qs and conj(U) on qs+n
  (rho -> U rho U^dag  ==  (U (x) U*) |rho>),
* a Kraus channel {K_m} becomes ONE dense op on (qs, qs+n):
  S = sum_m kron(conj(K_m), K_m)  (bra bits above ket bits, little-endian
  over the sorted tuple — matching ir.oplist's Op basis convention),
* measurement statistics are the diagonal rho_ii = amplitude at index
  i + (i << n); purity tr(rho^2) is the squared norm of |rho>.

Superoperators are not unitary; the engines never assume unitarity (they
apply arbitrary dense blocks), so fusion and the wide/megakernel paths work
unchanged.  Capacity: n <= 15 mixed qubits — 2n = 30 runs through the
in-place prefetch engine on four column halves with the split-half
measurement helpers (no flat 2^30 buffer is ever made); complex128 runs at
any n <= 14 through the float64 torch apply primitives (engine/naive.py
``run_oplist``) for parity checking, launching no hand kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .config import SimulatorConfig
from .ir.circuit import Circuit, Gate
from .ir.oplist import Op, circuit_to_ops

# ----------------------------------------------------------------- channels


def kraus_depolarizing(p: float) -> List[np.ndarray]:
    """Single-qubit depolarizing channel: rho -> (1-p) rho + p I/2."""
    x = np.array([[0, 1], [1, 0]], dtype=complex)
    y = np.array([[0, -1j], [1j, 0]], dtype=complex)
    z = np.diag([1.0, -1.0]).astype(complex)
    i = np.eye(2, dtype=complex)
    return [
        np.sqrt(1 - 3 * p / 4) * i,
        np.sqrt(p / 4) * x,
        np.sqrt(p / 4) * y,
        np.sqrt(p / 4) * z,
    ]


def kraus_dephasing(p: float) -> List[np.ndarray]:
    """Phase-flip channel: off-diagonals shrink by (1 - p)."""
    z = np.diag([1.0, -1.0]).astype(complex)
    return [np.sqrt(1 - p / 2) * np.eye(2, dtype=complex), np.sqrt(p / 2) * z]


def kraus_bit_flip(p: float) -> List[np.ndarray]:
    x = np.array([[0, 1], [1, 0]], dtype=complex)
    return [np.sqrt(1 - p) * np.eye(2, dtype=complex), np.sqrt(p) * x]


def kraus_amplitude_damping(gamma: float) -> List[np.ndarray]:
    """T1 decay: |1><1| population decays by gamma."""
    k0 = np.array([[1, 0], [0, np.sqrt(1 - gamma)]], dtype=complex)
    k1 = np.array([[0, np.sqrt(gamma)], [0, 0]], dtype=complex)
    return [k0, k1]


def kraus_depolarizing2(p: float) -> List[np.ndarray]:
    """Correlated two-qubit depolarizing channel:
    rho -> (1-p) rho + p/15 sum_{(a,b) != (I,I)} (Pa x Pb) rho (Pa x Pb).

    The standard gate-noise model for entangling gates (one correlated
    error event per gate, uniform over the 15 non-identity Pauli pairs) —
    NOT the product of two independent single-qubit channels."""
    x = np.array([[0, 1], [1, 0]], dtype=complex)
    y = np.array([[0, -1j], [1j, 0]], dtype=complex)
    z = np.diag([1.0, -1.0]).astype(complex)
    i = np.eye(2, dtype=complex)
    paulis = (i, x, y, z)
    out = [np.sqrt(1 - p) * np.kron(i, i)]
    for a in range(4):
        for b in range(4):
            if a == b == 0:
                continue
            out.append(np.sqrt(p / 15) * np.kron(paulis[b], paulis[a]))
    return out


def kraus_thermal(t1: float, t2: float, time: float) -> List[np.ndarray]:
    """Thermal relaxation (zero temperature) for duration ``time``:
    populations decay with T1, coherences with T2 (requires T2 <= 2 T1).

    Composition of amplitude damping (gamma = 1 - e^{-t/T1}) with just
    enough pure dephasing that the off-diagonal factor is exactly
    e^{-t/T2}; the returned list is the composed channel's Kraus set
    (pairwise products), so it plugs into ``channel()``/``noise_kraus``
    like any other channel."""
    if t1 <= 0 or t2 <= 0 or time < 0:
        raise ValueError("t1, t2 must be positive and time non-negative")
    if t2 > 2 * t1 + 1e-12:
        raise ValueError(f"unphysical T2 = {t2} > 2 T1 = {2 * t1}")
    gamma = 1.0 - np.exp(-time / t1)
    # amplitude damping alone shrinks coherences by sqrt(1-gamma)
    lam = np.exp(-time / t2) / max(np.sqrt(1.0 - gamma), 1e-300)
    lam = min(lam, 1.0)
    ad = kraus_amplitude_damping(gamma)
    dz = kraus_dephasing(1.0 - lam)     # extra off-diagonal factor = lam
    return [d @ a for d in dz for a in ad]


NAMED_CHANNELS = {
    "depolarizing": kraus_depolarizing,
    "dephasing": kraus_dephasing,
    "bit_flip": kraus_bit_flip,
    "amplitude_damping": kraus_amplitude_damping,
    "depolarizing2": kraus_depolarizing2,
    "thermal": kraus_thermal,
}


def superoperator(kraus: Sequence[np.ndarray]) -> np.ndarray:
    """S = sum_m kron(conj(K_m), K_m): bra factor above the ket factor."""
    dim = kraus[0].shape[0]
    s = np.zeros((dim * dim, dim * dim), dtype=complex)
    for k in kraus:
        assert k.shape == (dim, dim)
        s += np.kron(np.conj(k), k)
    return s


@dataclass(frozen=True)
class Channel:
    kraus: Tuple[np.ndarray, ...]
    qubits: Tuple[int, ...]


@dataclass
class NoisyCircuit:
    """Gate stream + noise channels over n mixed qubits."""

    num_qubits: int
    items: List[Union[Gate, Channel]] = field(default_factory=list)

    def append(self, name: str, *qubits: int, params: Iterable[float] = ()):
        g = Gate(name, tuple(qubits), tuple(params))
        for q in g.qubits:
            if not (0 <= q < self.num_qubits):
                raise ValueError(f"qubit {q} out of range")
        self.items.append(g)
        return self

    def __getattr__(self, name):
        if name in ("h", "x", "sx", "z", "s", "sdg", "t", "tdg"):
            return lambda q: self.append(name, q)
        if name == "rz":
            return lambda theta, q: self.append("rz", q, params=(theta,))
        if name == "cx":
            return lambda c, t: self.append("cx", c, t)
        raise AttributeError(name)

    def channel(self, which: Union[str, Sequence[np.ndarray]], *qubits: int,
                **params):
        """Attach a noise channel: a NAMED_CHANNELS name (+ its parameter)
        or an explicit Kraus-operator list over the given qubits."""
        if isinstance(which, str):
            kraus = NAMED_CHANNELS[which](**params) if params else \
                NAMED_CHANNELS[which](0.0)
        else:
            kraus = [np.asarray(k, dtype=complex) for k in which]
        dim = kraus[0].shape[0]
        if dim != 1 << len(qubits):
            raise ValueError(
                f"channel dimension {dim} does not match {len(qubits)} qubit(s)")
        # completeness: sum K^dag K == I (trace preservation)
        acc = sum(k.conj().T @ k for k in kraus)
        if not np.allclose(acc, np.eye(dim), atol=1e-9):
            raise ValueError("Kraus operators do not satisfy sum K^dag K = I")
        self.items.append(Channel(tuple(kraus), tuple(qubits)))
        return self


@dataclass
class DensityResult:
    num_qubits: int
    re: "object"          # device-resident |rho> parts (2^(2n),) tensors
    im: "object"
    # n = 15 runs in place: |rho> as the four (R2, 128) column-half tensors
    # (engine/prefetch.py split layout) — never joined to a flat 2^30 buffer
    halves: Optional[tuple] = None

    def probabilities(self) -> np.ndarray:
        """Diagonal of rho: outcome probabilities (length 2^n, host)."""
        import torch

        n = self.num_qubits
        dev = (self.re if self.halves is None else self.halves[0]).device
        # diagonal index i + (i << n)
        idx = torch.arange(1 << n, device=dev) * ((1 << n) + 1)
        if self.halves is None:
            return self.re[idx].cpu().numpy()
        re0, re1, _, _ = self.halves
        r = idx >> 8
        c = idx & 255
        lo = re0[r, torch.clamp(c, max=127)]
        hi = re1[r, torch.clamp(c - 128, min=0)]
        return torch.where(c < 128, lo, hi).cpu().numpy()

    def purity(self) -> float:
        """tr(rho^2) = || |rho> ||^2."""
        if self.halves is not None:
            from .sampling import norm_halves

            return float(norm_halves(*self.halves))
        from .sampling import norm_device

        return float(norm_device(self.re, self.im))

    def matrix(self) -> np.ndarray:
        """Dense rho (small n only: 4^n complex entries)."""
        if self.halves is not None:
            from .engine.prefetch import join_halves

            re, im = join_halves(*self.halves)
        else:
            re, im = self.re, self.im
        rho = re.cpu().numpy() + 1j * im.cpu().numpy()
        n = self.num_qubits
        return rho.reshape(1 << n, 1 << n).T  # [bra, ket] -> rho[ket, bra]

    def expectation_z(self, qubits: Sequence[int]) -> float:
        p = self.probabilities()
        idx = np.arange(p.shape[0])
        par = np.zeros_like(idx)
        for q in qubits:
            par ^= (idx >> q) & 1
        return float(np.sum(p * (1.0 - 2.0 * par)))

    def sample(self, num_samples: int, seed: int = 0) -> np.ndarray:
        p = np.maximum(self.probabilities(), 0.0)
        p = p / p.sum()
        rng = np.random.default_rng(seed)
        return rng.choice(p.shape[0], size=num_samples, p=p)


class DensitySimulator:
    """Run NoisyCircuits as vectorized density matrices on the port's
    engines, on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, config: Optional[SimulatorConfig] = None,
                 device="cuda"):
        from .ops.apply import resolve_device

        self.config = config or SimulatorConfig()
        self.device = resolve_device(device)

    def _doubled_ops(self, nc: NoisyCircuit) -> List[Op]:
        n = nc.num_qubits
        out: List[Op] = []
        for item in nc.items:
            if isinstance(item, Gate):
                for op in circuit_to_ops(Circuit(n, [item])):
                    from .ir.oplist import op_matrix

                    u, qs = op_matrix(op)
                    out.append(Op("u", qs, u))
                    out.append(
                        Op("u", tuple(q + n for q in qs), np.conj(u)))
            else:
                order = np.argsort(item.qubits)
                sorted_qs = tuple(int(item.qubits[i]) for i in order)
                if sorted_qs != item.qubits:
                    from .ir.oplist import permute_basis

                    kraus = [
                        permute_basis(k, list(item.qubits), list(sorted_qs))
                        for k in item.kraus
                    ]
                else:
                    kraus = list(item.kraus)
                s = superoperator(kraus)
                qs = sorted_qs + tuple(q + n for q in sorted_qs)
                out.append(Op("u", qs, s))
        return out

    def run(self, nc: NoisyCircuit) -> DensityResult:
        import torch

        from .engine.megakernel import build_megakernel
        from .ops.apply import initial_state_parts
        from .passes.fuse_k import fuse_k

        n = nc.num_qubits
        nn = 2 * n
        dev = self.device
        if nn > 30:
            raise ValueError(
                f"density simulation doubles the register: n <= 15 (got {n})")
        if nn > 28 and self.config.dtype == "complex128":
            raise ValueError(
                "complex128 density simulation supports n <= 14; n = 15 "
                "needs the float32 in-place engine")
        ops = self._doubled_ops(nc)
        if self.config.dtype == "complex128":
            # float64 path for parity checking at ANY n <= 14: the torch
            # apply primitives place dense blocks at arbitrary positions
            # (bra-side ops live entirely on high qubits).  No hand kernel
            # runs float64, so this is the route at every width, the
            # smallest included.  Slower than the f32 engines; exact.
            from .engine.naive import run_oplist

            re, im = initial_state_parts(nn, dtype=torch.float64,
                                         device=dev)
            # cap fusion at 2 qubits: wider blocks route through the
            # float32 wide apply
            ops = fuse_k(ops, max_qubits=2)
            re, im = run_oplist(ops, nn, re, im)
        elif nn <= 7:
            re, im = initial_state_parts(nn, device=dev)
            ops = fuse_k(ops, max_qubits=nn)
            re, im = build_megakernel(ops, nn, dev)(re, im)
        elif nn == 8:
            # only qubit 7 is above the lane region: the wide engine hosts
            # every op (kh <= 1) without any planning
            from .engine.wide import build_wide_program

            re, im = initial_state_parts(nn, device=dev)
            ops = fuse_k(ops, max_qubits=7, max_high=2)
            re, im = build_wide_program(
                ops, nn, precision=self.config.effective_precision(nn),
                device=dev)(re, im)
        else:
            # Bra-side ops live entirely on high qubits, so the wide engine's
            # lanes+kh<=2 placement cannot host them — but the prefetch
            # planner swaps ANY op's qubits into the matmul window and
            # routes the state back to the canonical basis in-plan.
            from .engine.prefetch import build_prefetch_program, initial_halves

            inplace = self.config.prefetch_inplace
            if inplace is None:
                # the doubled register hits the single-card ceiling at
                # 2n = 30: in-place chains + split-half measurement helpers
                inplace = nn >= 30
            ops = fuse_k(ops, max_qubits=7)
            prog = build_prefetch_program(
                ops, nn, precision=self.config.effective_precision(nn),
                final_layout=np.arange(nn), inplace=bool(inplace),
                device=dev)
            if inplace:
                parts = prog.run_parts(*initial_halves(nn, device=dev))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                return DensityResult(n, None, None, halves=tuple(parts))
            re, im = initial_state_parts(nn, device=dev)
            re, im = prog(re, im)
        return DensityResult(n, re, im)
