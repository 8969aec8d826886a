"""Dynamic circuits: mid-circuit measurement, reset, classical control.

The port of ``gpu_quantum_simulator_tpu/dynamic.py``.  The circuit model
(``DynamicCircuit`` and its items) and ``_split_segments`` are the JAX
package's host code.  The reference's measurement support is a disabled
end-of-circuit sampling loop (quantum_simulator.c:68-73, 256-283);
mid-circuit measurement does not exist there.  A ``DynamicCircuit`` is a
program of unitary segments interleaved with measurements, resets,
classically-controlled gates and noise events, executed as Born-rule
trajectories.

Execution: unitary segments run through the Simulator's layout-closed
program path (``_build_program``, the engine of ``run_device_parts``) on
device-resident (re, im) tensors — each segment a plain ``Circuit`` built
once and served from the program caches.  Measurements collapse the state
on the device.  ``run_dynamic`` runs one trajectory at a time and waits
for each measurement's outcome (a host uniform decides against device
probabilities, as in the JAX package); ``run_dynamic_batched`` runs 2^s
trajectories as the top s qubits of one (n + s)-qubit state, and its
collapse, noise and Kraus passes are torch ops over all shot blocks at
once (the JAX package's jitted ensemble passes), drawing their uniforms
from a ``torch.Generator`` on the device — nothing waits for the device
until the classical bits are fetched, once, at the end.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from .config import SimulatorConfig
from .engine.simulator import _real_dtype
from .ir.circuit import Circuit, Gate


@dataclass(frozen=True)
class Measure:
    qubit: int
    clbit: int


@dataclass(frozen=True)
class Reset:
    qubit: int


@dataclass(frozen=True)
class CondGate:
    """Apply ``gate`` iff classical bit ``clbit`` equals ``value``."""

    gate: Gate
    clbit: int
    value: int = 1


@dataclass(frozen=True)
class Noise:
    """Stochastic noise event (trajectory unraveling).

    Kinds match density.NAMED_CHANNELS: ``depolarizing`` (X/Y/Z each w.p.
    p/4), ``dephasing`` (Z w.p. p/2), ``bit_flip`` (X w.p. p),
    ``amplitude_damping`` (quantum-jump unraveling of the T1 Kraus pair),
    and the correlated two-qubit ``depolarizing2`` (one Pauli PAIR drawn
    uniformly from the 15 non-identity pairs w.p. p — set ``qubit2``).
    Trajectory averages converge to the DensitySimulator channel exactly
    (differential tests), but trajectories scale as state VECTORS — noisy
    simulation at any n the pure engines reach, vs the 2n-qubit density
    ceiling."""

    kind: str
    qubit: int
    p: float
    qubit2: Optional[int] = None


NOISE_KINDS = ("depolarizing", "dephasing", "bit_flip", "amplitude_damping",
               "depolarizing2")


@dataclass(frozen=True)
class KrausNoise:
    """Arbitrary quantum channel as a stochastic trajectory event.

    Per shot, branch m is drawn with its Born weight ||K_m psi||^2 and the
    state becomes K_m psi / ||K_m psi|| — the standard Monte-Carlo
    unraveling, so trajectory averages reproduce the exact channel
    (differential-tested against DensitySimulator on the same Kraus set).
    Supports 1- and 2-qubit channels; matrices are in the little-endian
    basis over the SORTED qubit tuple (the density.Channel convention)."""

    kraus: Tuple[np.ndarray, ...]
    qubits: Tuple[int, ...]


Item = Union[Gate, Measure, Reset, CondGate, Noise, KrausNoise]


@dataclass
class DynamicCircuit:
    """An n-qubit circuit with measurements and classical control flow."""

    num_qubits: int
    num_clbits: int = 0
    items: List[Item] = field(default_factory=list)

    def _check_q(self, q: int) -> None:
        if not (0 <= q < self.num_qubits):
            raise ValueError(f"qubit {q} outside [0, {self.num_qubits})")

    def _check_c(self, c: int) -> None:
        if not (0 <= c < self.num_clbits):
            raise ValueError(f"clbit {c} outside [0, {self.num_clbits})")

    def append(self, name: str, *qubits: int, params: Iterable[float] = ()):
        g = Gate(name, tuple(qubits), tuple(params))
        for q in g.qubits:
            self._check_q(q)
        self.items.append(g)
        return self

    _GATE_HELPERS = frozenset(
        {"h", "x", "y", "z", "sx", "sxdg", "id", "s", "sdg", "t", "tdg",
         "rz", "rx", "ry", "p", "u", "cx"})

    def __getattr__(self, name):
        # delegate gate helpers (h/x/cx/rz/...) to append, mirroring Circuit
        if name in DynamicCircuit._GATE_HELPERS:
            def helper(*args, **kwargs):
                probe = Circuit(self.num_qubits)
                getattr(probe, name)(*args, **kwargs)
                self.items.extend(probe.gates)
                return self

            return helper
        raise AttributeError(name)

    def measure(self, qubit: int, clbit: int):
        self._check_q(qubit)
        self._check_c(clbit)
        self.items.append(Measure(qubit, clbit))
        return self

    def reset(self, qubit: int):
        self._check_q(qubit)
        self.items.append(Reset(qubit))
        return self

    def c_if(self, clbit: int, name: str, *qubits: int,
             params: Iterable[float] = (), value: int = 1):
        self._check_c(clbit)
        g = Gate(name, tuple(qubits), tuple(params))
        for q in g.qubits:
            self._check_q(q)
        self.items.append(CondGate(g, clbit, value))
        return self

    def to_qasm(self) -> str:
        """Serialize to the dynamic OpenQASM-3 subset parse_qasm_dynamic
        accepts.  Noise events have no QASM spelling and are rejected."""
        lines = [
            "OPENQASM 3.0;",
            'include "stdgates.inc";',
            f"qubit[{self.num_qubits}] q;",
        ]
        if self.num_clbits:
            lines.append(f"bit[{self.num_clbits}] c;")

        def gate_str(g: Gate) -> str:
            head = f"{g.name}({g.params[0]!r})" if g.params else g.name
            args = ", ".join(f"q[{q}]" for q in g.qubits)
            return f"{head} {args};"

        for item in self.items:
            if isinstance(item, Gate):
                lines.append(gate_str(item))
            elif isinstance(item, Measure):
                lines.append(f"c[{item.clbit}] = measure q[{item.qubit}];")
            elif isinstance(item, Reset):
                lines.append(f"reset q[{item.qubit}];")
            elif isinstance(item, CondGate):
                lines.append(
                    f"if (c[{item.clbit}] == {item.value}) "
                    + gate_str(item.gate))
            else:
                raise ValueError(
                    f"{type(item).__name__} has no QASM spelling")
        return "\n".join(lines) + "\n"

    def noise(self, kind: str, qubit: int, p: float,
              qubit2: Optional[int] = None):
        """Insert a stochastic noise event (see ``Noise``).  The correlated
        two-qubit ``depolarizing2`` kind requires ``qubit2``."""
        if kind not in NOISE_KINDS:
            raise ValueError(f"unknown noise kind {kind!r}; one of {NOISE_KINDS}")
        if not (0.0 <= p <= 1.0):
            raise ValueError(f"noise probability must be in [0, 1], got {p}")
        self._check_q(qubit)
        if (kind == "depolarizing2") != (qubit2 is not None):
            raise ValueError("qubit2 is required for depolarizing2 "
                             "and only for depolarizing2")
        if qubit2 is not None:
            self._check_q(qubit2)
            if qubit2 == qubit:
                raise ValueError("depolarizing2 needs two distinct qubits")
            self.items.append(Noise(kind, qubit, float(p), qubit2))
            return self
        self.items.append(Noise(kind, qubit, float(p)))
        return self

    def thermal(self, qubit: int, t1: float, t2: float, time: float):
        """Insert T1/T2 thermal relaxation (density.kraus_thermal) as a
        Born-weighted Kraus trajectory event on ``qubit``."""
        from .density import kraus_thermal

        return self.noise_kraus(kraus_thermal(t1, t2, time), qubit)

    def noise_kraus(self, kraus, *qubits: int):
        """Insert an arbitrary 1- or 2-qubit channel (see ``KrausNoise``).

        ``kraus``: matrices over the given qubits, little-endian basis over
        the sorted tuple; must satisfy sum K^dag K = I (trace preservation).
        """
        if not (1 <= len(qubits) <= 2):
            raise ValueError("noise_kraus supports 1- or 2-qubit channels")
        for q in qubits:
            self._check_q(q)
        if len(set(qubits)) != len(qubits):
            raise ValueError("noise_kraus qubits must be distinct")
        mats = [np.asarray(k, dtype=complex) for k in kraus]
        dim = 1 << len(qubits)
        for k in mats:
            if k.shape != (dim, dim):
                raise ValueError(
                    f"Kraus operator shape {k.shape} != ({dim}, {dim})")
        acc = sum(k.conj().T @ k for k in mats)
        if not np.allclose(acc, np.eye(dim), atol=1e-9):
            raise ValueError("Kraus operators do not satisfy sum K^dag K = I")
        if len(qubits) == 2 and qubits[0] > qubits[1]:
            from .ir.oplist import permute_basis

            sq = (qubits[1], qubits[0])
            mats = [permute_basis(k, list(qubits), list(sq)) for k in mats]
            qubits = sq
        self.items.append(KrausNoise(tuple(mats), tuple(qubits)))
        return self


@dataclass
class TrajectoryResult:
    state: Optional[np.ndarray]      # final amplitudes (None if not requested)
    clbits: Tuple[int, ...]          # classical register after the run


def _split_segments(dc: DynamicCircuit, n: int) -> List[Tuple[str, object]]:
    """Maximal unitary segments interleaved with non-unitary items.

    Conditional gates split segments because their presence depends on
    runtime clbits.  ``n`` may exceed ``dc.num_qubits`` (batched ensembles
    lift circuits to the padded width; gate indices are unchanged)."""
    segments: List[Tuple[str, object]] = []   # ("circuit", Circuit) | item
    cur = Circuit(n)
    for item in dc.items:
        if isinstance(item, Gate):
            cur.gates.append(item)
            continue
        if cur.gates:
            segments.append(("circuit", cur))
            cur = Circuit(n)
        segments.append(("item", item))
    if cur.gates:
        segments.append(("circuit", cur))
    return segments


def _np_dtype(real_dtype):
    return np.float64 if real_dtype == torch.float64 else np.float32


def run_dynamic(
    dc: DynamicCircuit,
    config: Optional[SimulatorConfig] = None,
    shots: int = 1,
    seed: int = 0,
    return_states: bool = False,
    device="cuda",
) -> List[TrajectoryResult]:
    """Execute ``shots`` Born-rule trajectories of a dynamic circuit.

    Each trajectory replays the program; unitary segments are served from
    the Simulator's program caches so repeated shots re-plan nothing.
    Uniforms come from ``np.random.default_rng(seed)`` in the JAX
    package's order, so a seed gives the JAX package's classical bits
    (up to float32 ties at a Born threshold).  Each measurement waits for
    its outcome.  For many shots at moderate n, prefer
    ``run_dynamic_batched`` — it executes ALL trajectories as one ensemble.
    """
    from .engine.simulator import Simulator
    from .ops.apply import initial_state_parts, join_state
    from .sampling import measure_qubit_device

    cfg = config or SimulatorConfig()
    sim = Simulator(cfg, device=device)
    n = dc.num_qubits
    rng = np.random.default_rng(seed)
    real_dtype = _real_dtype(cfg)

    # Pre-split the program into maximal unitary segments (shared by all
    # trajectories).  Per-item helper circuits (reset flips, conditional
    # gates) are built ONCE so every shot hits the same program-cache
    # entries.
    segments = _split_segments(dc, n)
    flip_for: dict = {}
    cond_for: dict = {}
    for kind, seg in segments:
        if kind == "item" and isinstance(seg, Reset):
            flip = Circuit(n)
            flip.x(seg.qubit)
            flip_for[seg.qubit] = flip
        elif kind == "item" and isinstance(seg, CondGate):
            one = Circuit(n)
            one.gates.append(seg.gate)
            cond_for[id(seg)] = one

    results: List[TrajectoryResult] = []
    for _ in range(shots):
        re, im = initial_state_parts(n, dtype=real_dtype, device=sim.device)
        clbits = [0] * dc.num_clbits

        for kind, seg in segments:
            # device-resident throughout: only the 1-bit measurement
            # outcomes reach the host
            if kind == "circuit":
                re, im = _run_segment(sim, seg, re, im)
                continue
            if isinstance(seg, Measure):
                re, im, out = measure_qubit_device(
                    re, im, seg.qubit, float(rng.random()))
                clbits[seg.clbit] = out
            elif isinstance(seg, Reset):
                re, im, out = measure_qubit_device(
                    re, im, seg.qubit, float(rng.random()))
                if out == 1:
                    re, im = _run_segment(sim, flip_for[seg.qubit], re, im)
            elif isinstance(seg, CondGate):
                if clbits[seg.clbit] == seg.value:
                    re, im = _run_segment(sim, cond_for[id(seg)], re, im)
            elif isinstance(seg, Noise):
                u = torch.full((1,), rng.random(), dtype=real_dtype,
                               device=sim.device)
                re, im = _apply_noise(re, im, seg, n, 0, u, real_dtype)
            elif isinstance(seg, KrausNoise):
                u = torch.full((1,), rng.random(), dtype=real_dtype,
                               device=sim.device)
                re, im = _apply_kraus(re, im, seg, n, 0, u, real_dtype)
            else:  # pragma: no cover
                raise AssertionError(seg)
        state = None
        if return_states:
            state = join_state(re, im)
        results.append(TrajectoryResult(state, tuple(clbits)))
    return results


def _run_segment(sim, circuit: Circuit, re, im, copy: bool = False):
    """One unitary segment on the trajectory's own (re, im) pair.

    The pair is handed to the program, which writes into it (the JAX
    package donates it instead): the trajectory owns its state, so the
    copy ``run_device_parts`` makes first buys nothing and holds a second
    state.  ``copy=True`` goes through ``run_device_parts``, for the
    measurement of the copies' share (chip_smoke.py, chip_ab.py)."""
    if copy:
        re, im, _ = sim.run_device_parts(circuit, (re, im))
        return re, im
    sim = sim._resolved(circuit.num_qubits)
    fn, _ = sim._build_program(circuit)
    return fn(re.contiguous(), im.contiguous())


def _bit_ctx(q: int, n: int, s: int, dtype, device="cuda"):
    """A view of a flat (2^(n+s),) ensemble exposing bit ``q``.

    Returns (shape, flip, b1, bc): the reshape target (S, hi, 2, 2^q), a
    bit-q flip callable (an exact ``flip`` of the 2-axis), the bit-q
    indicator broadcastable against that view (made on ``device`` by
    ``arange``, with no copy from the host) and the per-shot broadcast
    shape.  The JAX package lowers lane bits (q < 7) to 128x128 0/1
    matmuls instead, against its TPU tile padding; a card has no such
    padding, so the view is the plain one at every q.
    """
    S = 1 << s
    shape = (S, 1 << (n - 1 - q), 2, 1 << q)
    b1 = torch.arange(2, dtype=dtype, device=device).reshape(1, 1, 2, 1)
    bc = (S,) + (1,) * (len(shape) - 1)
    return shape, (lambda a: a.flip(2)), b1, bc


def _clamp(x, tiny: float):
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, min=tiny)
    return max(x, tiny)


def _measure_ensemble(re, im, q: int, n: int, s: int, u):
    """Collapse qubit ``q`` across all 2^s trajectory blocks at once.

    The ensemble is flat (2^(n+s),) with the shot index in the high s
    bits; the _bit_ctx view exposes the measured bit so Born
    probabilities, outcome draws, and the projective renormalization are a
    few elementwise+reduce passes — no per-shot dispatch, no host
    round-trip."""
    shape, _flip, b1, bc = _bit_ctx(q, n, s, re.dtype, re.device)
    re_v, im_v = re.reshape(shape), im.reshape(shape)
    red = tuple(range(1, len(shape)))
    p1 = torch.sum((re_v * re_v + im_v * im_v) * b1, dim=red)
    out = (u < p1).to(torch.int32)              # per-shot Born outcome
    norm = torch.where(out == 1, p1, 1.0 - p1)
    outf = out.to(re.dtype).reshape(bc)
    sel = outf * b1 + (1.0 - outf) * (1.0 - b1)
    scale = sel / torch.sqrt(torch.clamp(norm, min=1e-30)).reshape(bc)
    return (re_v * scale).reshape(-1), (im_v * scale).reshape(-1), out


def _pauli_probs(kind: str, p: float) -> Tuple[float, float, float]:
    """(P(X), P(Y), P(Z)) for the Pauli-mixture channels, matching the
    density.NAMED_CHANNELS Kraus weights exactly."""
    if kind == "depolarizing":
        return p / 4, p / 4, p / 4
    if kind == "dephasing":
        return 0.0, 0.0, p / 2
    if kind == "bit_flip":
        return p, 0.0, 0.0
    raise ValueError(kind)


def _pauli_hits(re, im, q: int, n: int, s: int, x_hit, y_hit, z_hit):
    """Apply per-shot Pauli selections on qubit ``q``: the (S,) boolean
    masks pick X/Y/Z (else identity), applied exactly (including Y's
    complex structure — no global-phase shortcut).

    Y = [[0, -i], [i, 0]]: (Yψ)_b = i·(2b-1)·ψ_{1-b}, i.e. with
    sign = 1-2·b1: re_Y = sign·flip(im), im_Y = -sign·flip(re)."""
    shape, flip, b1, bc = _bit_ctx(q, n, s, re.dtype, re.device)
    re_v, im_v = re.reshape(shape), im.reshape(shape)
    xm, ym, zm = (h.reshape(bc) for h in (x_hit, y_hit, z_hit))
    sign = 1.0 - 2.0 * b1
    fre, fim = flip(re_v), flip(im_v)
    out_re = torch.where(xm, fre,
                         torch.where(ym, sign * fim,
                                     torch.where(zm, sign * re_v, re_v)))
    out_im = torch.where(xm, fim,
                         torch.where(ym, -sign * fre,
                                     torch.where(zm, sign * im_v, im_v)))
    return out_re.reshape(-1), out_im.reshape(-1)


def _pauli_ensemble(re, im, q: int, n: int, s: int, probs, u):
    """Per-shot random Pauli on qubit ``q``: I/X/Y/Z drawn from the
    cumulative thresholds of ``probs`` = (px, py, pz)."""
    px, py, pz = probs[0], probs[1], probs[2]
    x_hit = u < px
    y_hit = (u >= px) & (u < px + py)
    z_hit = (u >= px + py) & (u < px + py + pz)
    return _pauli_hits(re, im, q, n, s, x_hit, y_hit, z_hit)


def _pauli2_ensemble(re, im, qa: int, qb: int, n: int, s: int, p, u):
    """Correlated two-qubit depolarizing: with probability ``p`` one of
    the 15 non-identity Pauli pairs (uniform) hits (qa, qb) per shot —
    the trajectory unraveling of density.kraus_depolarizing2.  ONE
    uniform draw selects the pair: m in 1..15, sigma_{m&3} on qa and
    sigma_{m>>2} on qb (all pairs equally weighted, so the packing is
    distribution-neutral)."""
    hit = u < p
    k = torch.floor(u / _clamp(p, 1e-30) * 15)
    m = torch.clamp(k.to(torch.int32), 0, 14) + 1
    m = torch.where(hit, m, torch.zeros_like(m))
    ia, ib = m & 3, m >> 2
    re, im = _pauli_hits(re, im, qa, n, s, ia == 1, ia == 2, ia == 3)
    return _pauli_hits(re, im, qb, n, s, ib == 1, ib == 2, ib == 3)


def _damp_ensemble(re, im, q: int, n: int, s: int, gamma, u):
    """Quantum-jump unraveling of amplitude damping on qubit ``q``.

    Per shot: jump w.p. gamma * P(1) — the |1> component moves to |0>
    (K1 = |0><1| = flip ∘ bit-1 mask, renormalized); otherwise
    K0 = diag(1, sqrt(1-gamma)) applies, renormalized by
    sqrt(1 - gamma * P(1)).  Averaging trajectories reproduces the
    density channel (kraus_amplitude_damping)."""
    shape, flip, b1, bc = _bit_ctx(q, n, s, re.dtype, re.device)
    re_v, im_v = re.reshape(shape), im.reshape(shape)
    red = tuple(range(1, len(shape)))
    p1 = torch.sum((re_v * re_v + im_v * im_v) * b1, dim=red)
    pjump = gamma * p1
    jump = (u < pjump).reshape(bc)

    inv1 = (1.0 / torch.sqrt(torch.clamp(p1, min=1e-30))).reshape(bc)
    re_j = flip(re_v * b1) * inv1
    im_j = flip(im_v * b1) * inv1

    k0 = (1.0 - b1) + (1.0 - gamma) ** 0.5 * b1
    invn = (1.0 / torch.sqrt(torch.clamp(1.0 - pjump, min=1e-30))
            ).reshape(bc)
    out_re = torch.where(jump, re_j, re_v * k0 * invn)
    out_im = torch.where(jump, im_j, im_v * k0 * invn)
    return out_re.reshape(-1), out_im.reshape(-1)


_LANE_QUBITS = 7          # the JAX package's lane width (_kraus_form's cases)
_TILE_QUBITS = 10         # bits 0-9: one (8, 128) TPU layout tile block


def _kraus_form(qs: Tuple[int, ...], n: int) -> str:
    """The JAX package's lowering name for Kraus targets ``qs`` (lane,
    tile, mixed, row1, row2), kept so both packages name a case alike.

    The lane/tile/mixed forms lift the channel into 128- or 1024-wide 0/1
    embeddings against TPU tile padding; on a card ``_kraus_ensemble``
    computes every form through the row views (row1/row2), which give the
    same K psi."""
    lo = min(qs)
    if lo >= _LANE_QUBITS:
        return "row1" if len(qs) == 1 else "row2"
    if max(qs) < _LANE_QUBITS and n > _LANE_QUBITS:
        return "lane"
    if max(qs) < _TILE_QUBITS:
        return "tile" if n > _TILE_QUBITS else (
            "row1" if len(qs) == 1 else "row2")
    return "mixed"


def _kraus_ensemble(re, im, qs: tuple, n: int, s: int, form: str,
                    kre, kim, u):
    """Monte-Carlo unraveling of an arbitrary channel on an ensemble.

    ``kre``/``kim``: real/imag (k, d, d) Kraus stacks over the sorted
    targets (little-endian).  Per shot: p_m = ||K_m psi||^2 (trace
    preservation makes them sum to 1), branch idx drawn from the
    cumulative weights of one uniform, state replaced by
    K_idx psi / sqrt(p_idx).  ``form`` is the JAX package's name for the
    case (``_kraus_form``); every form runs through the row views here,
    the contractions in IEEE fp32 (``ieee_fp32``, the JAX package's
    precision="highest")."""
    from .kernels.wide import ieee_fp32

    S = 1 << s
    k = kre.shape[0]
    kr, ki = kre, kim
    if len(qs) == 1:
        q = qs[0]
        shape = (S, 1 << (n - 1 - q), 2, 1 << q)
        spec = "mij,shjl->mshil"
    else:
        qa, qb = qs
        shape = (S, 1 << (n - 1 - qb), 2, 1 << (qb - qa - 1), 2, 1 << qa)
        # matrix index r = 2*bit(qb) + bit(qa): axis 2 is qb, axis 4 is qa
        spec = "mbaBA,shBwAl->mshbwal"
        kr = kre.reshape(k, 2, 2, 2, 2)
        ki = kim.reshape(k, 2, 2, 2, 2)
    x_re = re.reshape(shape)
    x_im = im.reshape(shape)
    with ieee_fp32():
        ys_re = (torch.einsum(spec, kr, x_re)
                 - torch.einsum(spec, ki, x_im))       # (k, S, ...)
        ys_im = (torch.einsum(spec, kr, x_im)
                 + torch.einsum(spec, ki, x_re))
    red = tuple(range(2, ys_re.dim()))
    p = torch.sum(ys_re * ys_re + ys_im * ys_im, dim=red)   # (k, S)
    cum = torch.cumsum(p, dim=0)
    idx = torch.sum(u[None, :] >= cum, dim=0)                # (S,) 0..k-1
    idx = torch.clamp(idx, max=k - 1)
    sel = (torch.arange(k, device=re.device)[:, None] == idx[None, :])
    norm = torch.sum(torch.where(sel, p, torch.zeros_like(p)), dim=0)
    selx = sel.reshape((k, S) + (1,) * (ys_re.dim() - 2)).to(re.dtype)
    out_re = torch.sum(ys_re * selx, dim=0)
    out_im = torch.sum(ys_im * selx, dim=0)
    inv = (1.0 / torch.sqrt(torch.clamp(norm, min=1e-30))).reshape(
        (S,) + (1,) * (out_re.dim() - 1))
    return (out_re * inv).reshape(-1), (out_im * inv).reshape(-1)


def _apply_kraus(re, im, seg: KrausNoise, n: int, s: int, u, real_dtype):
    """Dispatch one KrausNoise event on a (possibly s=0) ensemble state.
    The Kraus stack goes up through pinned memory, with no wait."""
    from .ops.apply import upload

    form = _kraus_form(seg.qubits, n)
    stack = np.stack(seg.kraus)
    dt = _np_dtype(real_dtype)
    kre = upload(stack.real.astype(dt), re.device)
    kim = upload(stack.imag.astype(dt), re.device)
    return _kraus_ensemble(re, im, seg.qubits, n, s, form, kre, kim, u)


def _noise_run_fn(spec, n: int, s: int):
    """One callable applying a RUN of noise events (spec of (kind, qubit,
    qubit2) triples) in order; ``ps`` rows and ``us`` rows per event."""
    def body(re, im, ps, us):
        for j, (kind, q, q2) in enumerate(spec):
            if kind == "amplitude_damping":
                re, im = _damp_ensemble(re, im, q, n, s, ps[j, 0], us[j])
            elif kind == "depolarizing2":
                re, im = _pauli2_ensemble(re, im, q, q2, n, s,
                                          ps[j, 0], us[j])
            else:
                re, im = _pauli_ensemble(re, im, q, n, s, ps[j], us[j])
        return re, im

    return body


def _noise_run_params(run, real_dtype, device="cuda"):
    """(spec, ps) for a list of Noise items: ps rows are (px, py, pz) for
    Pauli mixtures, (gamma, 0, 0) for amplitude damping; ``ps`` goes up to
    ``device`` through pinned memory."""
    from .ops.apply import upload

    spec = tuple((seg.kind, seg.qubit, seg.qubit2) for seg in run)
    rows = []
    for seg in run:
        if seg.kind in ("amplitude_damping", "depolarizing2"):
            rows.append((seg.p, 0.0, 0.0))
        else:
            rows.append(_pauli_probs(seg.kind, seg.p))
    ps = np.asarray(rows, dtype=_np_dtype(real_dtype)).reshape(-1, 3)
    return spec, upload(ps, torch.device(device))


def _apply_noise(re, im, seg: Noise, n: int, s: int, u, real_dtype):
    """Dispatch one Noise event on a (possibly s=0) ensemble state."""
    if seg.kind == "amplitude_damping":
        return _damp_ensemble(re, im, seg.qubit, n, s, seg.p, u)
    if seg.kind == "depolarizing2":
        return _pauli2_ensemble(re, im, seg.qubit, seg.qubit2, n, s, seg.p,
                                u)
    return _pauli_ensemble(re, im, seg.qubit, n, s,
                           _pauli_probs(seg.kind, seg.p), u)


def _flip_where(re, im, q: int, n: int, s: int, cond):
    """X on qubit ``q`` for the trajectory blocks where ``cond`` is true."""
    shape, flip, _b1, bc = _bit_ctx(q, n, s, re.dtype, re.device)
    c = cond.to(torch.bool).reshape(bc)

    def f(x):
        xv = x.reshape(shape)
        return torch.where(c, flip(xv), xv).reshape(-1)

    return f(re), f(im)


def _event_generator(device, seed: int, event: int) -> torch.Generator:
    """The generator of one ensemble event, seeded from (seed, event) —
    the counterpart of ``jax.random.fold_in(PRNGKey(seed), event)``: a
    seed gives reproducible draws, not the JAX package's bits."""
    mixed = np.random.SeedSequence([int(seed) & 0xFFFFFFFF,
                                    int(event)]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(mixed[0]) & 0x7FFFFFFFFFFFFFFF)
    return gen


def run_dynamic_batched(
    dc: DynamicCircuit,
    config: Optional[SimulatorConfig] = None,
    shots: int = 256,
    seed: int = 0,
    return_states: bool = False,
    max_width: int = 28,
    device="cuda",
) -> List[TrajectoryResult]:
    """All ``shots`` Born-rule trajectories as ONE device-resident ensemble.

    2^s independent trajectories of an n-qubit state ARE one flat state of
    n+s qubits whose high s bits index the shot — so unitary segments run
    UNCHANGED through any engine at width n+s, and a mid-circuit
    measurement is one collapse pass over the ensemble with per-shot
    uniforms drawn on the device (a ``torch.Generator`` seeded from
    (seed, event): reproducible from the seed, not the JAX package's
    ``jax.random`` bits).  The classical bits stay on the device until the
    one fetch at the end.  Memory: (re, im) of 2^(n+s) floats — at n=20 a
    4096-shot f32 ensemble is 8 GB, so size ``shots`` to the card.

    ``shots`` is rounded up to a power of two internally; exactly
    ``shots`` trajectories are returned.  If the padded ensemble width
    n + s would exceed ``max_width`` (default 28, the flat engines'
    ceiling as in the JAX package — above it the in-place halves path
    takes over and flat parts no longer exist), the shot budget is split
    into sequential ensemble chunks automatically.
    """
    from .engine.simulator import Simulator
    from .ops.apply import join_state

    cfg = config or SimulatorConfig()
    sim = Simulator(cfg, device=device)
    n = dc.num_qubits
    s = max(0, (int(shots) - 1).bit_length())
    if n + s > max_width:
        if n >= max_width:
            raise ValueError(
                f"n={n} leaves no room for a batch under max_width="
                f"{max_width}; use run_dynamic for per-shot trajectories")
        chunk = 1 << (max_width - n)
        out: List[TrajectoryResult] = []
        done = 0
        while done < int(shots):
            take = min(chunk, int(shots) - done)
            out.extend(run_dynamic_batched(
                dc, config=config, shots=take, seed=seed + done,
                return_states=return_states, max_width=max_width,
                device=device))
            done += take
        return out
    re, im, clbits, S = _run_ensemble(dc, sim, s, seed)

    host_clbits = (torch.stack(clbits).cpu().numpy() if clbits
                   else np.zeros((0, S), np.int32))
    states = None
    if return_states:
        states = join_state(re, im).reshape(S, 1 << n)
    results = []
    for k in range(int(shots)):
        bits = tuple(int(c[k]) for c in host_clbits)
        results.append(TrajectoryResult(
            None if states is None else states[k], bits))
    return results


def _run_ensemble(dc: DynamicCircuit, sim, s: int, seed: int,
                  copy_segments: bool = False):
    """Core batched-ensemble loop: (re, im, clbits, S) at width n + s, all
    on the simulator's device and queued: no host wait.
    ``copy_segments``: see ``_run_segment``."""
    cfg = sim.config
    dev = sim.device
    n = dc.num_qubits
    S = 1 << s
    N = n + s
    real_dtype = _real_dtype(cfg)

    # every shot block starts in its own |0...0> (a fill, no host copy)
    dim = 1 << N
    re = torch.zeros(dim, dtype=real_dtype, device=dev)
    re.view(S, 1 << n)[:, :1].fill_(1.0)
    im = torch.zeros(dim, dtype=real_dtype, device=dev)

    segments = _split_segments(dc, N)
    # coalesce consecutive noise events into single-call runs
    merged: List[Tuple[str, object]] = []
    for kind, seg in segments:
        if kind == "item" and isinstance(seg, Noise) and merged \
                and merged[-1][0] == "noise_run":
            merged[-1][1].append(seg)
        elif kind == "item" and isinstance(seg, Noise):
            merged.append(("noise_run", [seg]))
        else:
            merged.append((kind, seg))
    segments = merged
    cond_for: dict = {}
    for kind, seg in segments:
        if kind == "item" and isinstance(seg, CondGate):
            one = Circuit(N)
            one.gates.append(seg.gate)
            cond_for[id(seg)] = one

    def uniforms(shape, event):
        return torch.rand(shape, generator=_event_generator(dev, seed, event),
                          dtype=real_dtype, device=dev)

    clbits: List[object] = [torch.zeros(S, dtype=torch.int32, device=dev)
                            for _ in range(dc.num_clbits)]
    event = 0
    for kind, seg in segments:
        if kind == "circuit":
            re, im = _run_segment(sim, seg, re, im, copy_segments)
            continue
        if kind == "noise_run":
            us = uniforms((len(seg), S), event)
            event += 1
            spec, ps = _noise_run_params(seg, real_dtype, dev)
            re, im = _noise_run_fn(spec, n, s)(re, im, ps, us)
            continue
        if isinstance(seg, (Measure, Reset)):
            u = uniforms((S,), event)
            event += 1
            re, im, out = _measure_ensemble(re, im, seg.qubit, n, s, u)
            if isinstance(seg, Measure):
                clbits[seg.clbit] = out
            else:                      # Reset: flip the shots that read 1
                re, im = _flip_where(re, im, seg.qubit, n, s, out)
        elif isinstance(seg, CondGate):
            # the speculative branch runs on a copy (run_device_parts
            # copies its input) so the kept state survives
            cre, cim, _ = sim.run_device_parts(cond_for[id(seg)], (re, im))
            hit = (clbits[seg.clbit] == seg.value).reshape(S, 1)
            M = 1 << n
            re = torch.where(hit, cre.reshape(S, M), re.reshape(S, M)
                             ).reshape(-1)
            im = torch.where(hit, cim.reshape(S, M), im.reshape(S, M)
                             ).reshape(-1)
        elif isinstance(seg, KrausNoise):
            u = uniforms((S,), event)
            event += 1
            re, im = _apply_kraus(re, im, seg, n, s, u, real_dtype)
        else:  # pragma: no cover
            raise AssertionError(seg)

    return re, im, clbits, S


def with_noise(
    circuit: Circuit,
    kind: str = "depolarizing",
    p1: float = 0.0,
    p2: float = 0.0,
    correlated: bool = False,
) -> DynamicCircuit:
    """Lift a pure circuit into a DynamicCircuit with per-gate noise.

    After every 1-qubit gate a ``kind`` event with probability ``p1`` hits
    its qubit; after every 2-qubit gate, either ``p2`` hits BOTH
    participating qubits independently (the default
    independent-single-qubit-error model) or — with ``correlated=True`` —
    ONE correlated ``depolarizing2`` event hits the pair (uniform over the
    15 non-identity Pauli pairs w.p. ``p2``).  Gates on 3+ qubits fall
    back to independent per-qubit events in both modes.
    """
    dc = DynamicCircuit(circuit.num_qubits)
    for g in circuit.gates:
        dc.items.append(g)
        p = p2 if len(g.qubits) >= 2 else p1
        if p <= 0.0:
            continue
        if correlated and len(g.qubits) == 2:
            dc.noise("depolarizing2", g.qubits[0], p, qubit2=g.qubits[1])
        else:
            for q in g.qubits:
                dc.noise(kind, q, p)
    return dc


def expectation_noisy(
    circuit: Circuit,
    terms,
    shots: int = 1024,
    kind: str = "depolarizing",
    p1: float = 0.0,
    p2: float = 0.0,
    seed: int = 0,
    config: Optional[SimulatorConfig] = None,
    max_width: int = 28,
    correlated: bool = False,
    device="cuda",
) -> float:
    """<H> = sum_k c_k <P_k> under a per-gate noise model, via trajectories.

    Terms use the observables.expectation_pauli_sum spec.  Per
    qubit-wise-commuting group (observables.qwc_groups)
    the noisy circuit (+ noiseless measurement-basis rotations) runs as ONE
    batched ensemble; because every shot block is unit-norm, the
    trajectory-averaged <Z-string> is a single global signed reduction over
    the flat ensemble divided by the shot count — no per-shot readout at
    all.  Noisy VQE/QAOA cost evaluation at state-vector widths.
    """
    from .engine.simulator import Simulator
    from .observables import _parse_pauli, _with_rotations, qwc_groups
    from .sampling import expectation_z

    cfg = config or SimulatorConfig()
    n = circuit.num_qubits
    if n >= max_width:
        raise ValueError(f"n={n} leaves no room for a batch under "
                         f"max_width={max_width}")
    s_full = max(0, (int(shots) - 1).bit_length())
    s_chunk = min(s_full, max_width - n)

    parsed = []
    const = 0.0
    for coeff, pauli in terms:
        ops = _parse_pauli(pauli, n)
        if not ops:
            const += coeff
            continue
        parsed.append((float(coeff), ops))

    noisy = with_noise(circuit, kind, p1, p2, correlated=correlated)
    sim = Simulator(cfg, device=device)
    total = const
    for basis, members in qwc_groups(parsed):
        rotated_tail = _with_rotations(Circuit(n), basis)
        dc = DynamicCircuit(n, items=list(noisy.items) + list(rotated_tail.gates))
        sums = [0.0 for _ in members]
        done = 0
        while done < int(shots):
            s = min(s_chunk, max(0, (int(shots) - done - 1).bit_length()))
            re, im, _, S = _run_ensemble(dc, sim, s, seed + done)
            for j, (_, ops) in enumerate(members):
                # Z-mask over the LOW n bits: each unit-norm shot block
                # contributes its own <Z...>; the flat reduction sums all
                # S of them (every block is a valid trajectory)
                sums[j] += expectation_z(re, im, list(ops), n + s)
            done += S
        for j, (coeff, _) in enumerate(members):
            total += coeff * sums[j] / done
    return total


def sample_noisy(
    circuit: Circuit,
    shots: int,
    kind: str = "depolarizing",
    p1: float = 0.0,
    p2: float = 0.0,
    seed: int = 0,
    config: Optional[SimulatorConfig] = None,
    correlated: bool = False,
    readout_error: float = 0.0,
    device="cuda",
) -> np.ndarray:
    """One measurement sample per noisy trajectory, fully device-resident.

    Runs ``with_noise(circuit)`` as ONE batched ensemble and then measures
    every qubit (n collapse passes over the ensemble), yielding one
    basis-state index per shot — the noisy analog of ``Simulator.sample``.
    Only the (shots, n) outcome bits cross the device boundary.

    ``readout_error``: classical symmetric readout noise — each reported
    outcome bit flips independently with this probability (applied to the
    1-bit outcomes on the host with the JAX package's numpy seeding; the
    quantum state is untouched, matching the standard
    measurement-assignment-error model).
    """
    dc = with_noise(circuit, kind, p1, p2, correlated=correlated)
    n = circuit.num_qubits
    dc.num_clbits = n
    for q in range(n):
        dc.measure(q, q)
    results = run_dynamic_batched(dc, config=config, shots=shots, seed=seed,
                                  device=device)
    out = np.zeros(len(results), dtype=np.int64)
    for k, r in enumerate(results):
        idx = 0
        for q, bit in enumerate(r.clbits):
            idx |= bit << q
        out[k] = idx
    if readout_error > 0.0:
        rng = np.random.default_rng(np.uint64(seed) ^ np.uint64(0x9E3779B97F4A7C15))
        flips = rng.random((len(out), n)) < readout_error
        masks = flips @ (1 << np.arange(n, dtype=np.int64))
        out ^= masks.astype(np.int64)
    return out
