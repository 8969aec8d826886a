"""Plain state-vector reference over four quarters, one a card: complex64,
one gate at a time, in torch.

The state of n qubits is held as four quarters of 2^(n-2) amplitudes:
quarter c holds the basis indices c * 2^(n-2) .. (c + 1) * 2^(n-2) - 1, on
card c of the first four (on the CPU, all four on "cpu"), so no device
ever holds the whole state.  The two top qubits, n-2 and n-1, are the bits
of the quarter's index c; the n-2 others are local to a quarter.  The gate
set and conventions are ``statevector.py``'s (``rz`` is the reference
project's phase gate diag(1, e^{i theta}); ``cx(c, t)`` flips bit t where
bit c is 1).

- A gate on local qubits is applied to each quarter with
  ``statevector.apply_1q`` / ``apply_cx``.
- A 2x2 gate on a top qubit pairs quarters a and b (that qubit 0 and 1)
  and forms both new quarters from the old ones in blocks, b's block
  copied to a's card and the new b block copied back; a diagonal one (rz,
  z, s, t, ...) scales the quarters where it is not 1, each on its card.
- ``cx`` with a top control and a local target flips the target in the
  quarters whose control bit is 1; with a local control and a top target
  it exchanges, in blocks between the paired quarters' cards, the
  amplitudes whose control bit is 1; with both qubits at the top it
  exchanges two entries of the quarter list.

Nothing is fused or reordered.  Why complex64: a complex128 state of 34
qubits is 64 GiB a card, which does not fit beside the 32 GiB a card of the
program's kept state while the check runs; complex64 gate-by-gate
rounding, about sqrt(2445) x 6e-8 = 3e-6 relative over the sweep circuit,
stays more than 20x below what the "high" rung reads (6.7e-5 - 8.1e-5 at
n = 30) and far below the limits of ``correct``.

It imports nothing of the simulator under test and takes only gate lists.
``simulate`` returns a ``Quarters``, which ``check.amp_err`` and
``check.shots_z`` read as they read a flat reference.
"""

from __future__ import annotations

import torch

from benchmark.references import statevector as SV

QUARTERS = 4
TOP = 2                   # qubits that index the quarters
BLOCK = 1 << 27           # amplitudes a block of a cross-card step


def devices(device) -> list:
    """Quarter c's device: card c of the first four (cards repeat where a
    host has fewer), or ``device`` itself off the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * QUARTERS
    count = torch.cuda.device_count()
    return [torch.device("cuda", c % count) for c in range(QUARTERS)]


class Quarters:
    """A state of ``n`` qubits as four complex64 quarters (``parts``, in
    basis order; ``parts[c]`` may sit on any device).  ``numel()`` is
    2^n, ``device`` the first card; ``ref[a:b]`` copies that slice to it,
    joined across quarters where it spans them; ``ref[idx]`` gathers an
    int64 index tensor's amplitudes onto it."""

    def __init__(self, parts, n: int, device):
        self.parts = parts
        self.n = n
        self.size = 1 << (n - TOP)
        self.device = torch.device(device)

    def numel(self) -> int:
        return QUARTERS * self.size

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self.numel())
            if step != 1:
                raise ValueError("a slice of the reference has step 1")
            pieces = []
            for c, q in enumerate(self.parts):
                lo, hi = max(start, c * self.size), min(stop,
                                                        (c + 1) * self.size)
                if lo < hi:
                    pieces.append(q[lo - c * self.size:hi - c * self.size]
                                  .to(self.device))
            if not pieces:
                return torch.empty(0, dtype=torch.complex64,
                                   device=self.device)
            return pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        idx = torch.as_tensor(key, device=self.device).long()
        out = torch.empty(idx.shape, dtype=torch.complex64,
                          device=self.device)
        quarter, local = idx >> (self.n - TOP), idx & (self.size - 1)
        for c, q in enumerate(self.parts):
            sel = torch.nonzero(quarter == c).squeeze(1)
            if sel.numel():
                out[sel] = q[local[sel].to(q.device)].to(self.device)
        return out


def _pairs(bit: int):
    """(a, b) quarter indices that differ in ``bit`` alone, a's bit 0."""
    return [(a, a | bit) for a in range(QUARTERS) if not a & bit]


def _ranges(size: int, block: int):
    for s in range(0, size, block):
        yield s, min(s + block, size)


def _apply_top_1q(parts, bit: int, u, block: int) -> None:
    """U on the top qubit whose quarter-index bit is ``bit``."""
    (u00, u01), (u10, u11) = (tuple(complex(x) for x in row) for row in u)
    if u01 == 0 and u10 == 0:
        for c, q in enumerate(parts):
            d = u11 if c & bit else u00
            if d != 1:
                q.mul_(d)
        return
    for a, b in _pairs(bit):
        qa, qb = parts[a], parts[b]
        for s, e in _ranges(qa.numel(), block):
            xa, xb = qa[s:e], qb[s:e].to(qa.device)
            nb = xa * u10 + xb * u11
            xa.mul_(u00).add_(xb * u01)
            qb[s:e].copy_(nb)


def _flip_local(q, L: int, t: int, block: int) -> None:
    """X on local qubit ``t`` of a quarter of ``L`` qubits."""
    v = q.view(1 << (L - t - 1), 2, 1 << t)
    x0, x1 = v[:, 0, :], v[:, 1, :]
    dim = SV._widest(x0)
    for b0, b1 in zip(SV._blocks(x0, dim, block), SV._blocks(x1, dim, block)):
        tmp = b0.clone()
        b0.copy_(b1)
        b1.copy_(tmp)


def _cx_local_control_top_target(parts, L: int, control: int, bit: int,
                                 block: int) -> None:
    """Exchange between the quarters paired by ``bit`` the amplitudes
    whose local ``control`` bit is 1."""
    for a, b in _pairs(bit):
        xa = parts[a].view(1 << (L - control - 1), 2, 1 << control)[:, 1, :]
        xb = parts[b].view(1 << (L - control - 1), 2, 1 << control)[:, 1, :]
        dim = SV._widest(xa)
        for ba, bb in zip(SV._blocks(xa, dim, block),
                          SV._blocks(xb, dim, block)):
            tmp = ba.clone()
            ba.copy_(bb)
            bb.copy_(tmp)


def simulate(gates, num_qubits: int, device="cpu", block: int = BLOCK):
    """The final state of ``gates`` applied to |0...0>, as ``Quarters``:
    complex64 quarters on the first four cards of ``device``'s kind."""
    n = num_qubits
    L = n - TOP
    if L < 1:
        raise ValueError(f"{n} qubits: four quarters need at least 3")
    devs = devices(device)
    parts = [torch.zeros(1 << L, dtype=torch.complex64, device=d)
             for d in devs]
    parts[0][0] = 1
    for name, qubits, params in gates:
        if name == "cx":
            c, t = qubits
            if c < L and t < L:
                for q in parts:
                    SV.apply_cx(q, L, c, t, block)
            elif c >= L and t >= L:
                cb, tb = 1 << (c - L), 1 << (t - L)
                for a in range(QUARTERS):
                    if a & cb and not a & tb:
                        parts[a], parts[a | tb] = parts[a | tb], parts[a]
            elif c >= L:
                for a, q in enumerate(parts):
                    if a & (1 << (c - L)):
                        _flip_local(q, L, t, block)
            else:
                _cx_local_control_top_target(parts, L, c, 1 << (t - L),
                                             block)
            continue
        (q,) = qubits
        u = SV.matrix(name, params)
        if q < L:
            for part in parts:
                SV.apply_1q(part, L, q, u, block)
        else:
            _apply_top_1q(parts, 1 << (q - L), u, block)
    return Quarters(parts, n, devs[0])
