"""Naive engine: one dispatch of torch ops per gate.

The port of the JAX package's ``engine/naive.py``, the analog of the
reference's launch-per-gate variant (quantum_simulator_naive.cu:163-189),
kept as a baseline for the ablation rows: per-gate dispatch overhead is the
analog of per-gate cudaLaunchKernel overhead.  There each gate is one
jitted call; here it is the matching ``ops/apply.py`` primitive (four real
einsums in IEEE fp32, or float64 on a float64 state, for a 1q or 2q gate,
an exact copy for a CNOT), so no hand kernel is involved, as no Pallas
kernel is in the JAX package.

Every gate matrix of a run goes to the device once, before the first gate,
as one stacked table through ``ops/apply.py`` ``upload`` (page-locked
memory, no wait): a matrix sent per gate from pageable memory would make
the host wait for the device at every gate, and the ablation would time
round trips instead of dispatches.  The per-gate loop then reads only
views of that table: no ``.item()``, no copy to the host, no branch on
device data.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ir.circuit import Circuit
from ..ir.oplist import Op
from ..ops import apply as A


def _upload_tables(mats: List[np.ndarray], ref: torch.Tensor):
    """(re, im) views of every matrix in ``mats``, uploaded in ONE pinned
    copy: a flat table of the matrices back to back, in ``ref``'s float
    dtype (float32, or float64 for a float64 state)."""
    if not mats:
        return []
    flat = np.concatenate([np.asarray(m).reshape(-1) for m in mats])
    dtype = np.float64 if ref.dtype == torch.float64 else np.float32
    table = A.upload(np.stack([flat.real, flat.imag]).astype(dtype),
                     ref.device)
    views, off = [], 0
    for m in mats:
        d = m.shape[0]
        views.append((table[0, off:off + d * d].view(d, d),
                      table[1, off:off + d * d].view(d, d)))
        off += d * d
    return views


def run_naive(circuit: Circuit, re: torch.Tensor, im: torch.Tensor):
    """Apply the raw gate stream, one dispatch per gate."""
    n = circuit.num_qubits
    mats = _upload_tables([g.matrix() for g in circuit.gates if not g.is_cx],
                          re)
    j = 0
    for g in circuit.gates:
        if g.is_cx:
            re, im = A.apply_cnot(re, im, g.qubits[0], g.qubits[1], n)
        else:
            ur, ui = mats[j]
            j += 1
            re, im = A.apply_1q(re, im, ur, ui, g.qubits[0], n)
    return re, im


def run_oplist(ops: Sequence[Op], num_qubits: int, re: torch.Tensor,
               im: torch.Tensor):
    """Apply a fused op list (1q/2q/cx), one dispatch per op — the analog
    of the reference's preproces/4x4 host flush loops.  Wider blocks go
    through ``apply_kq`` with host matrices (its wide arm expands them on
    the host)."""
    n = num_qubits
    mats = iter(_upload_tables(
        [op.u for op in ops if op.kind != "cx" and op.width <= 2], re))
    for op in ops:
        if op.kind == "cx":
            re, im = A.apply_cnot(re, im, op.qubits[0], op.qubits[1], n)
        elif op.width == 1:
            re, im = A.apply_1q(re, im, *next(mats), op.qubits[0], n)
        elif op.width == 2:
            re, im = A.apply_2q(re, im, *next(mats), op.qubits[0],
                                op.qubits[1], n)
        else:
            # apply_kq rounds the float64 matrix to the state's dtype
            re, im = A.apply_kq(re, im, np.asarray(op.u.real),
                                np.asarray(op.u.imag), op.qubits, n)
    return re, im


def run_3in1(circuit: Circuit, re: torch.Tensor, im: torch.Tensor):
    """The reference "preproces_3in1" ablation, done correctly.

    The reference fuses both accumulator flushes and the CNOT into one
    kernel launch but (a) forgets to reset the target's accumulator
    (double-apply, quantum_simulator_preproces_3in1.cu:275) and (b) uses
    block-local __syncthreads() between grid-wide phases (:163-173), so its
    phases race.  Here the three stages are one dispatch group on one
    stream, whose order makes the race impossible, and both accumulators
    reset.  An empty accumulator flushes as the identity, as in the JAX
    package.
    """
    n = circuit.num_qubits
    eye = np.eye(2)
    acc = [None] * n
    steps = []   # ("3in1", c, t) | ("1q", q), matrices in ``mats`` order
    mats = []
    for g in circuit.gates:
        if g.is_cx:
            c, t = g.qubits
            mats += [eye if acc[c] is None else acc[c],
                     eye if acc[t] is None else acc[t]]
            steps.append(("3in1", c, t))
            acc[c] = acc[t] = None
        else:
            q = g.qubits[0]
            m = g.matrix()
            acc[q] = m if acc[q] is None else m @ acc[q]
    for q in range(n):
        if acc[q] is not None:
            mats.append(acc[q])
            steps.append(("1q", q))

    tables = iter(_upload_tables(mats, re))
    for step in steps:
        if step[0] == "3in1":
            _, c, t = step
            re, im = A.apply_1q(re, im, *next(tables), c, n)
            re, im = A.apply_1q(re, im, *next(tables), t, n)
            re, im = A.apply_cnot(re, im, c, t, n)
        else:
            re, im = A.apply_1q(re, im, *next(tables), step[1], n)
    return re, im
