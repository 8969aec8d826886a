"""Plain state-vector reference: complex128, one gate at a time, in torch.

It follows the reference project's gate set (quantum_simulator.c): ``cx``
and the 2x2 gates ``id x sx z s sdg t tdg h`` and ``rz(theta)``, where
``rz`` is that project's phase gate diag(1, e^{i theta}).  Qubit q is bit
q of the basis index; ``cx(c, t)`` flips bit t where bit c is 1.

Each gate is applied to the whole state as strided views of it: a diagonal
gate scales the half whose bit is 1 in place, ``cx`` exchanges two quarters,
any other gate forms both new halves from the old ones.  The exchanges and
the 2x2 products run in blocks of at most ``block`` amplitudes, so the
temporaries stay small beside a 2^30 state.  Nothing here fuses gates or
reorders them.

It imports nothing of the simulator under test and takes only gate lists.
"""

from __future__ import annotations

import cmath
import math

import torch

BLOCK = 1 << 26

_S2 = 1 / math.sqrt(2)
FIXED = {
    "id": ((1, 0), (0, 1)),
    "x": ((0, 1), (1, 0)),
    "sx": ((0.5 + 0.5j, 0.5 - 0.5j), (0.5 - 0.5j, 0.5 + 0.5j)),
    "z": ((1, 0), (0, -1)),
    "s": ((1, 0), (0, 1j)),
    "sdg": ((1, 0), (0, -1j)),
    "t": ((1, 0), (0, cmath.exp(1j * math.pi / 4))),
    "tdg": ((1, 0), (0, cmath.exp(-1j * math.pi / 4))),
    "h": ((_S2, _S2), (_S2, -_S2)),
}


def matrix(name: str, params=()):
    """The 2x2 matrix of a one-qubit gate, as nested tuples of complex."""
    if name == "rz":
        (theta,) = params
        return ((1, 0), (0, cmath.exp(1j * theta)))
    if name not in FIXED:
        raise ValueError(f"gate {name!r} is outside the reference gate set")
    return FIXED[name]


def _blocks(view, dim: int, block: int):
    """Slices of ``view`` along ``dim``, each at most ``block`` elements."""
    step = max(1, block * view.shape[dim] // max(view.numel(), 1))
    for start in range(0, view.shape[dim], step):
        yield view.narrow(dim, start, min(step, view.shape[dim] - start))


def _widest(view) -> int:
    return max(range(view.dim()), key=lambda d: view.shape[d])


def apply_1q(psi, n: int, q: int, u, block: int = BLOCK) -> None:
    """psi <- U on qubit q, in place."""
    v = psi.view(1 << (n - q - 1), 2, 1 << q)
    (u00, u01), (u10, u11) = (tuple(complex(x) for x in row) for row in u)
    if u01 == 0 and u10 == 0:
        for half, d in ((0, u00), (1, u11)):
            if d != 1:
                v[:, half, :].mul_(d)
        return
    a, b = v[:, 0, :], v[:, 1, :]
    dim = _widest(a)
    for ab, bb in zip(_blocks(a, dim, block), _blocks(b, dim, block)):
        na = ab * u00 + bb * u01
        bb.mul_(u11).add_(ab * u10)
        ab.copy_(na)


def apply_cx(psi, n: int, control: int, target: int,
             block: int = BLOCK) -> None:
    """psi <- CX(control, target), in place: the amplitudes with the control
    bit 1 exchange their target bit."""
    hi, lo = max(control, target), min(control, target)
    v = psi.view(1 << (n - hi - 1), 2, 1 << (hi - lo - 1), 2, 1 << lo)
    if control == hi:
        x0, x1 = v[:, 1, :, 0, :], v[:, 1, :, 1, :]
    else:
        x0, x1 = v[:, 0, :, 1, :], v[:, 1, :, 1, :]
    dim = _widest(x0)
    for b0, b1 in zip(_blocks(x0, dim, block), _blocks(x1, dim, block)):
        tmp = b0.clone()
        b0.copy_(b1)
        b1.copy_(tmp)


def simulate(gates, num_qubits: int, device="cpu", block: int = BLOCK):
    """The final state of ``gates`` applied to |0...0>: a complex128 tensor
    of 2^num_qubits amplitudes on ``device``."""
    psi = torch.zeros(1 << num_qubits, dtype=torch.complex128, device=device)
    psi[0] = 1
    for name, qubits, params in gates:
        if name == "cx":
            apply_cx(psi, num_qubits, qubits[0], qubits[1], block)
        else:
            apply_1q(psi, num_qubits, qubits[0], matrix(name, params), block)
    return psi
